"""Whole runs of each cell on the CPU at test size: sound, under each fault
a cell can have (the timed path broken underneath), and with the control
in the program's place. The harness's look for a chip is skipped: these
call ``run_cell`` on the CPU, where the port runs its plain versions."""
from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import calibrate, check, spec
from benchmark.run import forbidden_modules, run_cell
from nconv_tpu_torch.runtime import StreamingEngine
from nconv_tpu_torch.training import UnguidedTask

CELLS = ("kitti-mixed-stream", "kitti-mixed-request", "kitti-step1-train")
SERVING = ("kitti-mixed-stream", "kitti-mixed-request")
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
