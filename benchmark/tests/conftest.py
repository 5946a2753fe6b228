"""A checkout root at test size: ``BENCHMARK.json`` and the benchmark's
data files copied into a temporary directory, the configurations cut to a
few rows and columns and the traffic to a few units, so that a whole run
of a cell fits a CPU test. The entries of ``benchmark/pending/`` (cells
measured but not yet held to a bound) are merged in, so their loops are
tested too."""
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


def make_root(dest: Path) -> Path:
    bench = dest / "benchmark"
    bench.mkdir(parents=True)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for pending in sorted((REPO / "benchmark" / "pending").glob("*.json")):
        for key, entries in json.loads(pending.read_text()).items():
            spec[key] += entries
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "benchmark" / sub, bench / sub)
    for name, size in TINY.items():
        path = bench / "configs" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **size}))
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
