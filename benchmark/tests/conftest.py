"""A checkout root at test size: ``BENCHMARK.json`` and the benchmark's
data files copied into a temporary directory, the configurations cut to a
few rows and columns and the traffic to a few units, so that a whole run
of a cell fits a CPU test. The entries of ``benchmark/pending/`` (cells
measured but not yet held to a bound) are merged in, so their loops are
tested too.

A configuration gives its own test size under ``"test_sizes"`` (the keys
it overrides, such as ``{"height": 64, "width": 96}``); only the tests
read that key, never a run. The two configurations that predate it take
theirs from ``TINY``."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the guided net zeroes 45 rows top and bottom: 112 rows leave 22 to compare
TINY = {"guided-kitti-mixed": {"height": 112, "width": 64},
        "step1-kitti-f32": {"height": 64, "width": 96}}
FEW = {"warm_units": 2, "trace_units": 2, "check_sample": 4}


def bench_spec(src: Path = REPO) -> dict:
    """``src``'s ``BENCHMARK.json`` with the entries of its ``pending/`` merged in."""
    spec = json.loads((src / "BENCHMARK.json").read_text())
    for pending in sorted((src / "benchmark" / "pending").glob("*.json")):
        for key, entries in json.loads(pending.read_text()).items():
            spec[key] += entries
    return spec


def loop_of(workload: str, src: Path = REPO) -> str:
    """The loop that ``workload``'s traffic names."""
    w = next(w for w in bench_spec(src)["workloads"] if w["name"] == workload)
    return json.loads((src / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())["loop"]


def tiny_size(name: str, cfg: dict) -> dict:
    """The keys that cut configuration ``name`` to test size."""
    if "test_sizes" in cfg:
        return cfg["test_sizes"]
    if name in TINY:
        return TINY[name]
    raise ValueError(f"configuration {name!r} gives no \"test_sizes\"")


def make_root(dest: Path, src: Path = REPO) -> Path:
    """A checkout at ``dest`` with ``src``'s benchmark cut to test size."""
    bench = dest / "benchmark"
    bench.mkdir(parents=True)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench_spec(src)))
    for sub in ("configs", "traffic", "metrics", "loops"):
        if (src / "benchmark" / sub).is_dir():
            shutil.copytree(src / "benchmark" / sub, bench / sub)
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        path.write_text(json.dumps({**cfg, **tiny_size(path.stem, cfg)}))
    for path in (bench / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update({k: v for k, v in FEW.items() if k in traffic})
        for ring in ("frames", "batches"):
            if ring in traffic:
                traffic[ring]["ring"] = 3
        path.write_text(json.dumps(traffic))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path / "checkout")
