"""The plain references pinned to the port's plain path on the CPU, at
small sizes: the same weights and inputs, the same numbers. (The tests may
import the port; the references may not.)"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import cells, check, generate
from benchmark.reference import guided, precision, step1
from conftest import REPO, TINY
from nconv_tpu_torch.models import NConvUNet
from nconv_tpu_torch.runtime import StreamingEngine
from nconv_tpu_torch.training import OptimizerConfig, TrainConfig, Trainer, UnguidedTask

SEED = 2**31 + 5


def _config(name):
    return {**json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text()), **TINY[name]}


@pytest.mark.parametrize("feature", ["bf16", "f32"])
def test_guided_reference_matches_the_engine(feature):
    cfg = _config("guided-kitti-mixed")
    traffic = json.loads((REPO / "benchmark/traffic/kitti-closed-loop.json").read_text())
    frames = generate.frames({**traffic["frames"], "ring": 2}, cfg["height"], cfg["width"], SEED)
    state = cells.guided_state(SEED, "cpu")
    dtype = cells.DTYPES[feature]
    engine = StreamingEngine({k: v.clone() for k, v in state.items()}, height=cfg["height"], width=cfg["width"],
                             compute_dtype=dtype, rgb_wire_dtype=np.uint8, device="cpu")
    for frame in frames:
        refs = guided.export(state, frame, cfg, feature=feature, depth="f32")
        for out, ref in zip(engine(*frame), refs):
            assert ref.abs().max() > 1.0  # the maps are not empty
            assert check.rel_rmse(out, ref) < (1e-4 if feature == "bf16" else 1e-6)


def test_step1_reference_matches_the_trainer():
    cfg = _config("step1-kitti-f32")
    traffic = json.loads((REPO / "benchmark/traffic/kitti-step1-batches.json").read_text())
    batches = generate.batches({**traffic["batches"], "ring": 3}, cfg["batch"], cfg["height"], cfg["width"], SEED)
    state = cells.step1_state(cfg, SEED, "cpu")
    model = NConvUNet(device="cpu")
    model.load_state_dict({k: v.clone() for k, v in state.items()})
    opt = cfg["optimizer"]
    trainer = Trainer(UnguidedTask(model), TrainConfig(batch_size=cfg["batch"],
                      optimizer=OptimizerConfig("adamw", opt["lr"], opt["weight_decay"])), device="cpu")
    dev = [{k: torch.from_numpy(b[k]) for k in ("depth", "gt")} for b in batches]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [float(trainer.train_step(b)) for b in dev]
    ref_losses, _, params = step1.train(state, dev, opt)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    # elementwise, AdamW's first steps move a leaf's near-zero gradients by
    # +-lr on rounding; the check compares each leaf's change by its norm
    program = {"loss": losses, "grad": {n: 0.0 for n in start},
               "update": {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}}
    ref = check.reference_training(cfg, state, batches, "cpu")
    readings = check.compare_training(program, ref)
    assert readings["loss_rel"] < 1e-6 and readings["update_gap"] < 1e-3, readings


def test_precisions():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 - 2**-12, 448.0 * 3])
    # TF32 keeps 10 mantissa bits, rounding to nearest even
    assert precision.tf32(x).tolist() == [1.0, 1.0 + 2**-9, -3.0, 448.0 * 3]
    assert precision.bf16(torch.tensor([1.0 + 2**-9])).item() == 1.0
    y = torch.linspace(-5, 5, 101)
    q = precision.fp8(y)
    assert q.abs().max() == 5.0 and 0 < (q - y).abs().max() < 5 * 2**-4
    assert precision.fp8(torch.zeros(3)).tolist() == [0.0, 0.0, 0.0]
