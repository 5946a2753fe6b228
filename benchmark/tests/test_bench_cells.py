"""Whole runs of each cell on the CPU at test size: sound, under each fault
a cell can have (the timed path broken underneath), and with the control
in the program's place. The harness's look for a chip is skipped: these
call ``run_cell`` on the CPU, where the port runs its plain versions. The
cells are those of ``BENCHMARK.json`` and ``benchmark/pending/``, so a cell
added as files is run here with no test edited."""
from __future__ import annotations

import hashlib
import json
import shutil
import time

import pytest
import torch

from benchmark import calibrate, cells, check, spec, work
from benchmark.run import forbidden_modules, run_cell
from conftest import REPO, TINY, bench_spec, loop_of, make_root
from nconv_tpu_torch.runtime import StreamingEngine
from nconv_tpu_torch.training import UnguidedTask

CELLS = [w["name"] for w in bench_spec()["workloads"]]
SERVING = [c for c in CELLS if loop_of(c) in ("stream", "request")]
SEED = 2**31 + 77


def run(root, workload, trace_on=False):
    return run_cell(spec.load(root, workload), SEED, 0.3, trace_on, "cpu", time.time())


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(tiny_root, workload):
    result = run(tiny_root, workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    cell = spec.load(tiny_root, workload)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in result["metrics"]
    assert forbidden_modules() == []


def _stale(orig):
    first = {}

    def forward(self, wire):
        out = orig(self, wire)
        return first.setdefault("out", out)
    return forward


SERVING_FAULTS = {
    # the state left unchanged: every request answered with the first one's maps
    "unchanged": _stale,
    # half the batch left out: the second stream's map never computed
    "half_batch": lambda orig: lambda self, wire: (orig(self, wire)[0], torch.zeros_like(orig(self, wire)[1])),
    # an answer altered where it is produced
    "altered": lambda orig: lambda self, wire: (orig(self, wire)[0] * 1.01, orig(self, wire)[1]),
}


@pytest.mark.parametrize("fault", sorted(SERVING_FAULTS))
@pytest.mark.parametrize("workload", SERVING)
def test_a_serving_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    monkeypatch.setattr(StreamingEngine, "forward_staged", SERVING_FAULTS[fault](StreamingEngine.forward_staged))
    assert not run(tiny_root, workload)["correct"]


def _half_loss(orig):
    def loss(self, batch, *, cfg):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return orig(self, half, cfg=cfg)
    return loss


TRAIN_FAULTS = {
    "unchanged": (torch.optim.AdamW, "step", lambda orig: lambda self, closure=None: None),
    "half_batch": (UnguidedTask, "loss", _half_loss),
    "altered": (UnguidedTask, "loss", lambda orig: lambda self, batch, *, cfg: orig(self, batch, cfg=cfg) * 1.01),
}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_a_training_fault_is_not_correct(tiny_root, monkeypatch, fault):
    owner, attr, plant = TRAIN_FAULTS[fault]
    monkeypatch.setattr(owner, attr, plant(getattr(owner, attr)))
    assert not run(tiny_root, "kitti-step1-train")["correct"]


@pytest.mark.parametrize("workload", ("kitti-mixed-stream", "kitti-step1-train"))
def test_the_control_is_not_correct(tiny_root, workload):
    cell = spec.load(tiny_root, workload)
    readings = calibrate.control_readings(cell, SEED, "cpu")
    for kind, numbers in readings.items():
        ok, table = check.judge(cell.config, numbers)
        assert not ok, (kind, table)


def test_a_cell_added_as_files_runs(tiny_root):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries, with no file edited."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "benchmark/configs/guided-kitti-mixed.json").read_text())
    (tiny_root / "benchmark/configs/guided-kitti-f32.json").write_text(
        json.dumps({**cfg, "feature_dtype": "f32", "rgb_wire_dtype": "float32",
                    "correct": {**cfg["correct"], "precision": {"feature": "f32", "depth": "f32"}}}))
    traffic = json.loads((tiny_root / "benchmark/traffic/kitti-closed-loop.json").read_text())
    traffic["frames"]["density"] = 0.2
    (tiny_root / "benchmark/traffic/kitti-dense-lidar.json").write_text(json.dumps(traffic))
    (tiny_root / "benchmark/metrics/slice_units.request.py").write_text(
        "def read(traced):\n    return traced.units\n")
    bench["configs"].append({"name": "guided-kitti-f32", "source": "https://arxiv.org/abs/1811.01791",
                             "file": "benchmark/configs/guided-kitti-f32.json", "reduced": [], "why": "f32"})
    bench["workloads"].append({"name": "kitti-f32-request", "config": "guided-kitti-f32",
                               "traffic": "kitti-dense-lidar", "chips": 1, "why": "f32 frames"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("request_"):
            m["workloads"].append("kitti-f32-request")
    bench["per_layer"].append({"name": "slice_units.request", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "engine", "moves": "request_p50_ms",
                               "workloads": ["kitti-f32-request"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert run(tiny_root, "kitti-f32-request")["correct"]
    traced = run(tiny_root, "kitti-f32-request", trace_on=True)
    assert traced["metrics"] == {"slice_units.request": {"value": 2, "unit": "requests"}}


@pytest.mark.parametrize("workload, loop", [
    ("kitti-mixed-stream", cells.Stream), ("kitti-mixed-request", cells.Request), ("kitti-step1-train", cells.Train),
])
def test_a_built_in_loop_is_the_class_of_cells(tiny_root, workload, loop):
    assert spec.load(tiny_root, workload).loop() is loop


TOY_LOOP = '''"""The guided request loop on a model that work.py does not count: the
unit is counted here, and the control is this file's own."""
from benchmark import cells, check, generate, work


def count(cfg):
    """Two 3x3 convs a stream, in the configuration's feature dtype."""
    unit = work.Work()
    h, w, b = cfg["height"], cfg["width"], cfg["streams"] * cfg["batch"]
    unit.add("toy.conv0", cfg["feature_dtype"], work.conv_flops(3, 8, 3, h, w, b), 3 * 8 * 9 + 8)
    unit.add("toy.conv1", cfg["feature_dtype"], work.conv_flops(8, 1, 3, h, w, b), 8 * 9 + 1)
    unit.bytes = b * h * w * 5
    return unit


class ToyRequest(cells.Request):
    def __init__(self, cfg, traffic, seed, device):
        # the engine serves the guided net; the built-in set-up counts it by that name
        super().__init__({**cfg, "model": "guided"}, traffic, seed, device)
        self.cfg, self.work = cfg, count(cfg)


LOOP = ToyRequest


def control(cell, seed, device):
    cfg = cell.config
    state = cells.guided_state(seed, device)
    frames = generate.frames(cell.traffic["frames"], cfg["height"], cfg["width"], seed)
    ring = range(len(frames))
    ref = check.reference_outputs(cfg, state, frames, ring, device, cfg["correct"]["precision"])
    low = check.reference_outputs(cfg, state, frames, ring, device, cfg["correct"]["control"])
    return {"toy_control": check.compare_serving(list(low.items()), ref)}
'''


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def test_a_loop_added_as_files_runs(tiny_root):
    """A loop file with its own count and control, a configuration of a
    model that ``work.py`` does not know, a traffic mix naming the loop and
    a metric reading the loop's count: new files and entries, no file
    edited, run untraced, traced and by ``calibrate``."""
    before = _digests(tiny_root)
    (tiny_root / "benchmark/loops").mkdir()
    (tiny_root / "benchmark/loops/toy-request.py").write_text(TOY_LOOP)
    cfg = json.loads((tiny_root / "benchmark/configs/guided-kitti-mixed.json").read_text())
    (tiny_root / "benchmark/configs/guided-toy.json").write_text(json.dumps({**cfg, "model": "guided-toy"}))
    traffic = json.loads((tiny_root / "benchmark/traffic/kitti-closed-loop.json").read_text())
    (tiny_root / "benchmark/traffic/toy-closed-loop.json").write_text(json.dumps({**traffic, "loop": "toy-request"}))
    (tiny_root / "benchmark/metrics/toy_gflop.request.py").write_text(
        "def read(traced):\n    return traced.work.flops() / 1e9\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "toy-request", "config": "guided-toy", "traffic": "toy-closed-loop",
                               "chips": 1, "why": "a loop of its own"})
    bench["configs"].append({"name": "guided-toy", "source": "https://arxiv.org/abs/1811.01791",
                             "file": "benchmark/configs/guided-toy.json", "reduced": [], "why": "a toy"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("request_"):
            m["workloads"].append("toy-request")
    bench["per_layer"].append({"name": "toy_gflop.request", "unit": "GFLOP", "better": "higher",
                               "source": "program_counter", "layer": "whole step", "moves": "request_p50_ms",
                               "workloads": ["toy-request"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    del before[tiny_root / "BENCHMARK.json"]  # the one file that takes new entries

    cell = spec.load(tiny_root, "toy-request")
    with pytest.raises(KeyError):
        work.of(cell.config)
    assert cell.loop().__name__ == "ToyRequest" and issubclass(cell.loop(), cells.Request)
    result = run(tiny_root, "toy-request")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"request_p50_ms", "request_p95_ms", "setup_s"}
    traced = run(tiny_root, "toy-request", trace_on=True)
    assert traced["correct"]
    gflop = cell.loop_file().count(cell.config).flops() / 1e9
    assert traced["metrics"] == {"toy_gflop.request": {"value": gflop, "unit": "GFLOP"}}
    readings = calibrate.control_readings(cell, SEED, "cpu")
    assert list(readings) == ["toy_control"]
    ok, table = check.judge(cell.config, readings["toy_control"])
    assert not ok, table
    assert {p: d for p, d in _digests(tiny_root).items() if p in before} == before


def test_an_unknown_loop_names_both_places(tiny_root):
    traffic = json.loads((tiny_root / "benchmark/traffic/kitti-closed-loop.json").read_text())
    (tiny_root / "benchmark/traffic/nowhere.json").write_text(json.dumps({**traffic, "loop": "nowhere"}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "nowhere-request", "config": "guided-kitti-mixed", "traffic": "nowhere",
                               "chips": 1, "why": "a loop nowhere"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SystemExit) as exit_:
        run(tiny_root, "nowhere-request")
    message = str(exit_.value)
    assert "benchmark.cells.LOOPS" in message and str(tiny_root / "benchmark/loops/nowhere.py") in message


def test_make_root_cuts_a_configuration_by_its_test_sizes(tmp_path):
    src = tmp_path / "src"
    (src / "benchmark").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", src)
    for sub in ("configs", "traffic", "metrics", "pending"):
        shutil.copytree(REPO / "benchmark" / sub, src / "benchmark" / sub)
    cfg = json.loads((src / "benchmark/configs/guided-kitti-mixed.json").read_text())
    sized = {**cfg, "test_sizes": {"height": 160, "width": 96}}
    (src / "benchmark/configs/guided-kitti-sized.json").write_text(json.dumps(sized))
    (src / "benchmark/loops").mkdir()
    (src / "benchmark/loops/toy-request.py").write_text(TOY_LOOP)
    root = make_root(tmp_path / "checkout", src)
    cut = json.loads((root / "benchmark/configs/guided-kitti-sized.json").read_text())
    assert cut == {**sized, "height": 160, "width": 96}
    for name, size in TINY.items():
        assert json.loads((root / f"benchmark/configs/{name}.json").read_text()).items() >= size.items()
    assert (root / "benchmark/loops/toy-request.py").read_text() == TOY_LOOP
    assert json.loads((root / "BENCHMARK.json").read_text()) == bench_spec(src)

    (src / "benchmark/configs/guided-kitti-unsized.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="guided-kitti-unsized"):
        make_root(tmp_path / "again", src)
