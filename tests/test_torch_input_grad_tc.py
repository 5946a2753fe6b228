"""The mixed schedule's two bf16 input cotangents on the tensor cores: a
stride-1 3x3 conv's (mode 0 of ``csrc/conv_tc.cu`` reading the forward
weight flipped and in/out-transposed as it stages it, counter
``conv_input_grad_tc``) and the 4x4/s2 transpose conv's (mode 4, a 4x4
stride-2 conv in column groups, counter ``conv4x4s2_tc``).

On the CPU:
  * routing, with the kernel library replaced by a stub that records each
    launch (``stub_card`` of tests/test_torch_backward_tc.py): bf16 calls
    reach ``nct_conv_tc`` in their modes, with no bias, no ReLU and the
    weight as stored, f32 calls ``nct_conv_kxk``, through the public
    gradient functions and through the stride-1 conv's and the transpose
    conv's autograd Functions; a call that a form cannot take raises before
    any launch;
  * the plain versions in bf16 against the JAX package's backward on the
    same bf16 operands: ``pallas_conv.transpose_conv_bhcw`` and the ``d_x``
    of ``pallas_s2._ct_bwd``, Pallas in interpret mode, at the guided net's
    channel pairs, within 4e-3 rel RMSE (about one bf16 ulp: both sum in f32
    and round once to bf16, in another order).

On the card (``cuda``-marked, skipped here) each form against its plain
version on ragged tiles within 5e-3 rel RMSE (the bf16 output rounding).
JAX is imported only by the tests that use it, so on the card this file
runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_input_grad_tc.py
"""
import numpy as np
import pytest
import torch

from nconv_tpu_torch import kernels, ops
from nconv_tpu_torch.ops import convops
from test_torch_backward_tc import stub_card

BF16 = torch.bfloat16
F32 = torch.float32


def _r(g, *s, dtype=F32, scale=1.0):
    return (torch.randn(*s, generator=g) * scale).to(dtype)


def _counts(**want):
    return {k: want.get(k, 0) for k in kernels.LAUNCHES}


# nct_conv_tc's arguments: (ptrs, meta, nparts, B, H, W, cin, cout, mode, w,
# w_dtype, w_flip, wsc, bias, bias_dtype, out, relu, stream)
_CIN, _COUT, _MODE, _W, _FLIP, _WSC, _BIAS, _RELU = 6, 7, 8, 9, 11, 12, 13, 16


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_input_grad_calls_reach_the_form_of_their_dtype(dtype):
    """bf16: mode 0 of ``nct_conv_tc`` with the forward weight as stored and
    the flip flag, and mode 4 with the transpose conv's weight; f32: K2's
    CUDA-core K x K form. Each counted once under its own name."""
    g = torch.Generator().manual_seed(10)
    w3, w4 = _r(g, 64, 128, 3, 3, dtype=dtype), _r(g, 65, 64, 4, 4, dtype=dtype)
    with stub_card() as stub:
        d_x = ops.conv2d_input_grad(_r(g, 1, 64, 9, 20, dtype=dtype), w3, 1)
        assert d_x.shape == (1, 128, 9, 20) and d_x.dtype == dtype
        d_x = ops.conv_transpose4x4s2_input_grad(_r(g, 1, 64, 19, 41, dtype=dtype), w4)
        assert d_x.shape == (1, 65, 9, 20) and d_x.dtype == dtype
    (n1, a1), (n2, a2) = stub.launched()
    if dtype == BF16:
        assert n1 == n2 == "nct_conv_tc"
        pick = lambda a: (a[_CIN], a[_COUT], a[_MODE], a[_FLIP], a[_WSC], a[_BIAS], a[_RELU])
        assert pick(a1) == (64, 128, 0, 1, None, None, 0)
        assert pick(a2) == (64, 65, 4, 0, None, None, 0)
        assert (a1[_W], a2[_W]) == (w3.data_ptr(), w4.data_ptr())  # as stored: no flipped copy
        assert kernels.launch_counts() == _counts(conv_input_grad_tc=1, conv4x4s2_tc=1)
    else:
        assert n1 == n2 == "nct_conv_kxk"
        assert kernels.launch_counts() == _counts(conv_kxk=1, conv4x4s2=1)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_stride1_and_transpose_function_backward_reach_the_form_of_their_dtype(dtype):
    """A stride-1 conv's and a transpose conv's autograd Functions: forward
    on K2 / K3 (``conv_tc`` / ``conv_transpose_tc`` in bf16), backward on the
    input-gradient forms and K6 of their dtype."""
    g = torch.Generator().manual_seed(11)
    x = _r(g, 1, 8, 10, 18, dtype=dtype).requires_grad_()
    w = _r(g, 16, 8, 3, 3, dtype=dtype).requires_grad_()
    wt = _r(g, 16, 9, 4, 4, dtype=dtype).requires_grad_()
    with stub_card():
        y = ops.conv3x3_trainable([x], w, None, relu=True)
        u = ops.conv_transpose4x4s2_trainable([y], wt, None, relu=True)
        u.backward(torch.zeros_like(u))
    want = (_counts(conv_tc=1, conv_transpose_tc=1, conv_input_grad_tc=1, conv4x4s2_tc=1, wgrad_tc=2)
            if dtype == BF16 else _counts(conv=1, conv_transpose=1, conv_kxk=1, conv4x4s2=1, wgrad=2))
    assert kernels.launch_counts() == want
    assert all(t.grad.dtype == dtype for t in (x, w, wt))


def test_input_grad_forms_refuse_what_they_cannot_take():
    """Each wrapper raises before launching on a dtype or shape that is not
    its form's: the tensor-core forms take bf16 only, K2's CUDA-core K x K
    form f32 only; no fallback."""
    g = torch.Generator().manual_seed(12)
    bf = lambda *s: _r(g, *s, dtype=BF16)
    cot, w3 = bf(1, 32, 9, 20), bf(32, 64, 3, 3)
    up, w4 = bf(1, 32, 18, 40), bf(33, 32, 4, 4)
    with stub_card() as stub:
        for bad, err in (
            (lambda: convops._conv_input_grad_tc_kernel(cot.float(), w3.float(), 1), TypeError),  # f32: conv_kxk
            (lambda: convops._conv4x4s2_tc_kernel(up.float(), w4.float()), TypeError),  # f32: conv4x4s2
            (lambda: convops._conv_kxk_kernel(cot, bf(32, 64, 3, 3), 1, 1), TypeError),  # bf16: the tc form
            (lambda: convops._conv_kxk_kernel(up, w4, 1, 2), TypeError),  # bf16: the tc form
            (lambda: convops._conv_input_grad_tc_kernel(cot, w3, 0), ValueError),  # not a pad-1 conv's
            (lambda: convops._conv_input_grad_tc_kernel(cot, bf(32, 129, 3, 3), 1), ValueError),  # > 128 out
            (lambda: convops._conv_input_grad_tc_kernel(cot, bf(32, 64, 5, 5), 1), ValueError),  # 5x5
            (lambda: convops._conv_input_grad_tc_kernel(cot, bf(16, 64, 3, 3), 1), ValueError),  # 16 != 32
            (lambda: convops._conv4x4s2_tc_kernel(up, bf(33, 32, 3, 3)), ValueError),  # 3x3 at stride 2
            (lambda: convops._conv4x4s2_tc_kernel(up, bf(33, 16, 4, 4)), ValueError),  # 16 != 32
            (lambda: convops._conv4x4s2_tc_kernel(up[:, :, :1, :1], w4), ValueError),  # under the footprint
            (lambda: ops.conv2d_input_grad(cot, w3.float(), 1), TypeError),  # mixed dtypes
            (lambda: ops.conv_transpose4x4s2_input_grad(up, w4.float()), TypeError),
        ):
            with pytest.raises(err):
                bad()
    assert stub.calls == [] and kernels.launch_counts() == _counts()


# ---------------------------------------------------------------------------
# The plain versions in bf16 against the JAX package's backward
# ---------------------------------------------------------------------------

def _bf16(a):
    """numpy f32 -> the nearest bf16 values, as f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _nchw(a):
    """(B, H, C, W) numpy -> (B, C, H, W) bf16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 1, 3)))).to(BF16)


@pytest.mark.parametrize("form,cg,co", [
    ("s1", 1, 32), ("s1", 32, 64), ("s1", 64, 128), ("4x4s2", 32, 33), ("4x4s2", 64, 65),
])
def test_bf16_input_grads_match_the_pallas_backward(form, cg, co):
    """``cg`` cotangent channels to ``co`` input-cotangent channels, B = 2,
    a 6 x 16 input: the port's bf16 ``conv2d_input_grad`` against
    ``transpose_conv_bhcw`` (stride 1, pad 1) and its
    ``conv_transpose4x4s2_input_grad`` against ``_ct_bwd``'s ``d_x``."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from nconv_tpu.ops import pallas_conv, pallas_s2

    rng = np.random.default_rng(100 * cg + co)
    b, h, w = 2, 6, 16
    j = lambda a: jnp.asarray(a, jnp.bfloat16)
    if form == "s1":
        cot = _bf16(rng.standard_normal((b, h, cg, w)))
        k = _bf16(rng.standard_normal((3, 3, co, cg)) * (9 * co) ** -0.5)  # the forward conv, HWIO
        with pltpu.force_tpu_interpret_mode():
            want = pallas_conv.transpose_conv_bhcw(j(cot), j(k), 1)
        got = ops.conv2d_input_grad(_nchw(cot), torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()).to(BF16), 1)
    else:
        cot = _bf16(rng.standard_normal((b, 2 * h, cg, 2 * w)))
        k = _bf16(rng.standard_normal((4, 4, co, cg)) * (4 * co) ** -0.5)  # the transpose conv, (kh, kw, cin, cout)
        with pltpu.force_tpu_interpret_mode():
            (want,), _, _ = pallas_s2._ct_bwd(((jnp.zeros((b, h, co, w), jnp.bfloat16),), j(k),
                                               jnp.zeros((), jnp.bfloat16)), j(cot))
        got = ops.conv_transpose4x4s2_input_grad(_nchw(cot),
                                                 torch.from_numpy(np.transpose(k, (2, 3, 0, 1)).copy()).to(BF16))
    assert got.dtype == BF16 and got.shape == (b, co, h, w)
    assert want.dtype == jnp.bfloat16
    assert _rel(np.transpose(got.float().numpy(), (0, 2, 1, 3)), np.asarray(want.astype(jnp.float32))) <= 4e-3


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _rel_t(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("cg,co,b,h,w", [
    (1, 32, 1, 37, 150), (32, 64, 2, 19, 76), (64, 128, 1, 44, 152), (64, 3, 1, 7, 13), (16, 8, 1, 5, 7),
])
def test_conv_input_grad_tc_matches_plain_version(card, cg, co, b, h, w):
    """Cotangent 1 to 64 channels, 3 to 128 out, odd H, W not a multiple of
    16; a channel-offset view of a wider cotangent too."""
    gen = torch.Generator(device=card).manual_seed(cg + co + h)
    cot = torch.randn(b, cg + 5, h, w, generator=gen, device=card).to(BF16)[:, 5:]
    wt = (torch.randn(cg, co, 3, 3, generator=gen, device=card) * (9 * co) ** -0.5).to(BF16)
    kernels.reset_launch_counts()
    for c in (cot, cot.contiguous()):
        got = ops.conv2d_input_grad(c, wt, 1)
        assert got.dtype == BF16 and got.shape == (b, co, h, w)
        assert _rel_t(got, ops.conv2d_input_grad_plain(c, wt, 1)) <= 5e-3
    counts = kernels.launch_counts()
    assert counts["conv_input_grad_tc"] == 2 and counts["conv_kxk"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cg,co,b,h,w", [
    (32, 33, 1, 38, 150), (64, 65, 2, 19, 37), (64, 65, 1, 88, 304), (16, 9, 1, 7, 16), (8, 1, 1, 5, 4),
    (32, 100, 1, 12, 40),
])
def test_conv4x4s2_tc_matches_plain_version(card, cg, co, b, h, w):
    """Output 1 to 100 channels (33 and 65: one and two column groups of
    48), odd H and W, a 2 x 2 output."""
    gen = torch.Generator(device=card).manual_seed(cg + co + h)
    cot = torch.randn(b, cg, h, w, generator=gen, device=card).to(BF16)
    wt = (torch.randn(co, cg, 4, 4, generator=gen, device=card) * (4 * co) ** -0.5).to(BF16)
    kernels.reset_launch_counts()
    got = ops.conv_transpose4x4s2_input_grad(cot, wt)
    assert got.dtype == BF16 and got.shape == (b, co, h // 2, w // 2)
    assert _rel_t(got, ops.conv_transpose4x4s2_input_grad_plain(cot, wt)) <= 5e-3
    counts = kernels.launch_counts()
    assert counts["conv4x4s2_tc"] == 1 and counts["conv4x4s2"] == 0
