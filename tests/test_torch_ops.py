"""Ops of the PyTorch port (nconv_tpu_torch.ops) against the JAX package.

Inputs are made with numpy from a seed and fed to both. The port runs on
CPU tensors, where every kernel wrapper runs its plain PyTorch version;
the kernels themselves are compared with those plain versions on the card
(tests/test_torch_kernels.py and chip_smoke.py). Bar: relative RMSE <= 1e-5 for
f32 (the two frameworks sum in different orders).
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nconv_tpu import ops as jops
from nconv_tpu_torch import ops

F32_BAR = 1e-5
RNG = np.random.default_rng(0)


def rand(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def nchw(x):  # numpy NHWC -> torch NCHW
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):  # torch NCHW -> numpy NHWC
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def oihw(k_hwio):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k_hwio, (3, 2, 0, 1))))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("pos_fn", ["softplus", "exp", "sigmoid", "softmax", "identity"])
def test_nconv2d_matches_jax(pos_fn):
    d = np.abs(rand(2, 16, 20, 3))
    c = (RNG.random((2, 16, 20, 3)) > 0.4).astype(np.float32)
    k, b = rand(5, 5, 3, 8) * 0.3, rand(8)
    want = jops.nconv2d(jnp.asarray(d), jnp.asarray(c), jnp.asarray(k), jnp.asarray(b),
                        padding=2, pos_fn=pos_fn)
    got = ops.nconv2d(nchw(d), nchw(c), oihw(k), torch.from_numpy(b), padding=2, pos_fn=pos_fn)
    for g, w in zip(got, want):
        assert rel(nhwc(g), w) <= F32_BAR


def test_max_pool_pair_matches_jax():
    x, c = rand(1, 17, 21, 8), rand(1, 17, 21, 8)
    want = jops.max_pool_pair(jnp.asarray(x), jnp.asarray(c))
    got = ops.max_pool_pair(nchw(x), nchw(c))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(nhwc(g), np.asarray(w))


@pytest.mark.parametrize("in_hw,out_hw", [((15, 20), (30, 40)), ((7, 9), (15, 20)), ((8, 8), (11, 13))])
def test_resize_nearest_matches_jax(in_hw, out_hw):
    x = rand(2, *in_hw, 3)
    want = jops.resize_nearest(jnp.asarray(x), out_hw)
    np.testing.assert_array_equal(nhwc(ops.resize_nearest(nchw(x), out_hw)), np.asarray(want))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("in_hw,out_hw,c", [((60, 80), (120, 160), 1), ((16, 24), (9, 13), 3), ((31, 17), (62, 34), 3)])
def test_resize_bilinear_matches_jax(align, in_hw, out_hw, c):
    x = rand(2, *in_hw, c)
    want = jops.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align)
    got = ops.resize_bilinear(nchw(x), out_hw, align_corners=align)
    assert rel(nhwc(got), want) <= F32_BAR


@pytest.mark.parametrize("factor", [1, 2, 4, 8])
def test_downscale_bilinear_matches_jax(factor):
    x = rand(1, 96, 128, 1)
    want = jops.downscale_bilinear(jnp.asarray(x), factor)
    got = ops.downscale_bilinear(nchw(x), factor)
    assert got.shape[2:] == want.shape[1:3]
    assert rel(nhwc(got), want) <= F32_BAR


@pytest.mark.parametrize("stride,padding,k", [(1, 2, 5), (1, 1, 3), (2, 1, 3), (1, 0, 3), (1, 2, 1)])
def test_conv2d_matches_jax(stride, padding, k):
    x, w, b = rand(2, 16, 20, 3), rand(k, k, 3, 5), rand(5)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=padding)
    got = ops.conv2d(nchw(x), oihw(w), torch.from_numpy(b), stride=stride, padding=padding)
    assert rel(nhwc(got), want) <= F32_BAR


def test_conv_transpose2d_matches_jax():
    x, w, b = rand(2, 12, 14, 6), rand(4, 4, 6, 4), rand(4)  # HWIO, I = input channels
    want = jops.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    w_t = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))))
    got = ops.conv_transpose2d(nchw(x), w_t, torch.from_numpy(b))
    assert rel(nhwc(got), want) <= F32_BAR


# ---------------------------------------------------------------------------
# The kernels' plain versions against JAX on the explicit concat / upsample
# ---------------------------------------------------------------------------

def _nconv_case(parts_spec, k, pad):
    """Full-res (H, W) = (16, 24); parts_spec lists (channels, up2)."""
    d_parts, c_parts = [], []
    for ch, up in parts_spec:
        h, w = (8, 12) if up else (16, 24)
        d_parts.append(np.abs(rand(2, h, w, ch)))
        c_parts.append((RNG.random((2, h, w, ch)) > 0.3).astype(np.float32))
    cin = sum(ch for ch, _ in parts_spec)
    return d_parts, c_parts, np.abs(rand(k, k, cin, 8)) + 0.1, rand(8)


def _jax_cat(parts, spec):
    full = [jnp.asarray(p) if not up else jops.resize_nearest(jnp.asarray(p), (16, 24))
            for p, (_, up) in zip(parts, spec)]
    return jnp.concatenate(full, -1)


@pytest.mark.parametrize("spec,k,pad,crop,pool", [
    ([(1, False)], 5, 2, 0, False),
    ([(8, False)], 5, 2, 0, True),
    ([(8, False), (8, True)], 3, 1, 0, False),
    ([(8, True), (8, False)], 3, 0, 0, False),
    ([(8, False)], 1, 2, 1, False),
])
def test_nconv_fused_plain_matches_jax(spec, k, pad, crop, pool):
    d, c, w, b = _nconv_case(spec, k, pad)
    wd, wc = jops.nconv2d(_jax_cat(d, spec), _jax_cat(c, spec), jnp.asarray(w), jnp.asarray(b),
                          padding=pad, pos_fn="identity")
    if crop:
        wd, wc = wd[:, crop:-crop, crop:-crop], wc[:, crop:-crop, crop:-crop]
    want = [wd, wc]
    if pool:
        want += list(jops.max_pool_pair(wd, wc))
    got = ops.nconv2d_fused([nchw(p) for p in d], [nchw(p) for p in c], oihw(w),
                            torch.from_numpy(b), padding=pad, up2=[u for _, u in spec],
                            crop=crop, pool_out=pool)
    assert len(got) == len(want)
    for g, ww in zip(got, want):
        assert g.shape[2:] == ww.shape[1:3]
        assert rel(nhwc(g), ww) <= F32_BAR


def _relu(x):
    return jnp.maximum(x, 0)


@pytest.mark.parametrize("form", ["plain", "relu_parts", "stride2", "residual", "residual_s2", "u8"])
def test_conv3x3_plain_matches_jax(form):
    chans = [5, 3] if form == "relu_parts" else [3]
    parts = [rand(2, 16, 20, ch) for ch in chans]
    if form == "u8":
        parts = [RNG.integers(0, 256, (2, 16, 20, 3)).astype(np.uint8)]
    cin = sum(chans)
    w, b, sc = rand(3, 3, cin, 8) * 0.2, rand(8), rand(1, 1, cin, 8) * 0.2
    stride = 2 if form.endswith("s2") or form == "stride2" else 1
    relu = form != "plain"
    x = jnp.concatenate([jnp.asarray(p.astype(np.float32)) for p in parts], -1)
    want = jops.conv2d(x, jnp.asarray(w), jnp.asarray(b), stride=stride, padding=1)
    if relu:
        want = _relu(want)
    residual = form.startswith("residual") or form == "u8"
    if residual:
        want = want + jops.conv2d(x, jnp.asarray(sc), stride=stride)
    t_parts = [torch.from_numpy(p).permute(0, 3, 1, 2) for p in parts]  # NHWC read by strides
    got = ops.conv3x3(t_parts, oihw(w), torch.from_numpy(b), stride=stride, relu=relu,
                      shortcut=oihw(sc) if residual else None)
    assert got.dtype == torch.float32
    assert rel(nhwc(got), want) <= F32_BAR


def test_conv_transpose4x4s2_plain_matches_jax():
    depth, feat = rand(2, 6, 7, 1), rand(2, 6, 7, 16)
    w, b = rand(4, 4, 17, 8) * 0.2, rand(8)
    want = _relu(jops.conv_transpose2d(jnp.concatenate([jnp.asarray(depth), jnp.asarray(feat)], -1),
                                       jnp.asarray(w), jnp.asarray(b)))
    w_t = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))))
    got = ops.conv_transpose4x4s2([nchw(depth), nchw(feat)], w_t, torch.from_numpy(b))
    assert got.shape == (2, 8, 12, 14)
    assert rel(nhwc(got), want) <= F32_BAR


def test_conv3x3_chain2_plain_matches_jax():
    x = rand(2, 12, 20, 16)
    w1, b1, w2, b2 = rand(3, 3, 16, 8) * 0.2, rand(8), rand(3, 3, 8, 8) * 0.3, rand(8)
    mid = _relu(jops.conv2d(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), padding=1))
    want = _relu(jops.conv2d(mid, jnp.asarray(w2), jnp.asarray(b2), padding=1))
    got = ops.conv3x3_chain2(nchw(x), oihw(w1), torch.from_numpy(b1), oihw(w2), torch.from_numpy(b2))
    assert rel(nhwc(got), want) <= F32_BAR


def test_bf16_plain_rounds_once():
    """bf16 parts: f32 arithmetic on the bf16 values, one rounding of the
    output (the kernels' contract), within bf16 resolution of f32 JAX."""
    x, w, b = rand(2, 12, 16, 8), rand(3, 3, 8, 8) * 0.2, rand(8)
    xb = nchw(x).to(torch.bfloat16)
    got = ops.conv3x3([xb], oihw(w).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16), relu=True)
    assert got.dtype == torch.bfloat16
    want = _relu(jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), padding=1))
    assert rel(nhwc(got), want) <= 1e-2


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, nconv_tpu_torch\n"
        "for m in pkgutil.walk_packages(nconv_tpu_torch.__path__, 'nconv_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'flax'))"
        " or n == 'nconv_tpu' or n.startswith('nconv_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('nconv_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


FORBIDDEN = ("jax", "flax", "nconv_tpu", "PIL", "matplotlib", "cv2")


def test_port_sources_import_none_of_what_the_card_lacks():
    """Every ``import`` in the port's sources and in chip_smoke.py, at any
    depth (inside functions too): none of jax, flax, the JAX package, PIL,
    matplotlib or cv2, which the card's machine does not have."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "nconv_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 30
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{f.relative_to(root)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
