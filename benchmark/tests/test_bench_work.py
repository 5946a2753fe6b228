"""The work counter: one conv and one normalized conv by hand, and the
totals of both configurations."""
from __future__ import annotations

import json

import pytest

from benchmark import work
from conftest import REPO
from nconv_tpu_torch.models import GuidedDepthNet, NConvUNet


def _config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def test_one_conv_and_one_nconv_by_hand():
    # the first RGB encoder conv: 3 -> 32, 3x3, both streams at 352x1216
    assert work.conv_flops(3, 32, 3, 352, 1216, 2) == 2 * 32 * 3 * 9 * 352 * 1216 * 2
    frame = work.guided_frame(_config("guided-kitti-mixed"))
    ops = {name: (dtype, flops, params) for name, dtype, flops, params in frame.ops}
    assert ops["rgb_encoder0"] == ("bf16", 2 * 32 * 3 * 9 * 352 * 1216 * 2, 3 * 32 * 9 + 32)
    # nconv2: 8 -> 8, 5x5, numerator and denominator convs, f32
    assert ops["nconv2"] == ("f32", 2 * (2 * 8 * 8 * 25 * 352 * 1216 * 2), 8 * 8 * 25 + 8)
    # the first transposed conv: 65 -> 64, 16 taps over 44x152 input pixels
    assert ops["fuse1.upf"][1] == 2 * 65 * 64 * 16 * 44 * 152 * 2


def test_the_totals():
    frame = work.guided_frame(_config("guided-kitti-mixed"))
    assert frame.flops("bf16") == 267_259_756_544
    assert frame.flops("f32") == 13_150_882_816
    assert frame.bytes == 9_700_228
    assert frame.least_s == pytest.approx(267_259_756_544 / 989e12 + 13_150_882_816 / 67e12)
    # every parameter of the served (folded) net is counted once
    served = sum(p.numel() for p in GuidedDepthNet(device="cpu", fold_bn=True).parameters())
    assert sum(p for *_, p in frame.ops) == served == _config("guided-kitti-mixed")["parameters_folded"]

    step = work.step1_train(_config("step1-kitti-f32"))
    assert step.flops("f32") == 77_481_662_464 and step.flops("bf16") == 0
    assert sum(p for *_, p in step.ops) == sum(p.numel() for p in NConvUNet(device="cpu").parameters()) == 10129
    # forward, weight cotangent, and the input cotangent but for the first layer
    fwd = sum(f for name, _, f, _ in step.ops if name.startswith("nconv") and "." not in name)
    first = next(f for name, _, f, _ in step.ops if name == "nconv1")
    pools = sum(f for name, _, f, _ in step.ops if name.startswith("pool"))
    assert step.flops() == 3 * fwd - first + pools
