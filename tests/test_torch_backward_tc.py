"""The mixed schedule's two backward forms on the tensor cores: K6's weight
cotangent from bf16 operands (``csrc/wgrad_tc.cu``, counter ``wgrad_tc``)
and the bf16 input cotangent of a 3x3 stride-2 conv (mode 3 of
``csrc/conv_tc.cu``, counter ``conv_transpose3x3s2_tc``).

On the CPU the kernel library is replaced by a stub that records the entry
each launch goes through, and the tensors are taken as on the card: bf16
calls reach the tensor-core entries and f32 calls the CUDA-core ones,
through the public gradient functions and through a stride-2 conv's
autograd Function; a call that a form cannot take raises before any launch.

On the card (``cuda``-marked, skipped here) each new kernel is held to its
plain version on ragged tiles (K6 within 1e-5 rel RMSE, its output being
f32; the 3x3/s2 form within 5e-3, the bf16 output rounding), and K6's
tensor-core form is bitwise repeatable. This file imports no jax, so on the
card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_backward_tc.py
"""
import contextlib
from unittest import mock

import pytest
import torch

from nconv_tpu_torch import kernels, ops
from nconv_tpu_torch.ops import convops

BF16 = torch.bfloat16
_SIZES = ("nct_wgrad_slices", "nct_wgrad_tc_slices")  # plan queries, not launches


class _StubLib:
    """Every entry returns 0 and records (name, args)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 1 if name in _SIZES else 0
        return entry

    def launched(self):
        return [(n, a) for n, a in self.calls if n not in _SIZES]


@contextlib.contextmanager
def stub_card():
    """The kernel library stubbed, and every CPU tensor taken as on the card."""
    stub = _StubLib()
    with mock.patch.object(kernels, "lib", lambda: stub), \
            mock.patch.object(kernels, "on_card", lambda *t: True), \
            mock.patch.object(kernels, "device_guard", lambda t: contextlib.nullcontext()), \
            mock.patch.object(kernels, "stream_of", lambda t: 0):
        kernels.reset_launch_counts()
        yield stub


def _r(g, *s, dtype=torch.float32):
    return torch.randn(*s, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_gradient_calls_reach_the_form_of_their_dtype(dtype):
    """bf16: ``nct_wgrad_tc`` and mode 3 of ``nct_conv_tc``; f32: ``nct_wgrad``
    and ``nct_conv_transpose3x3s2``; each counted once under its own name."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: _r(g, *s, dtype=dtype)
    x = [r(1, 5, 10, 18), r(1, 9, 10, 18)[:, 2:]]  # the second part a channel-offset view
    tc = dtype == BF16
    with stub_card() as stub:
        for stride, m in ((1, 1), (2, 128)):
            gp = [r(1, m, (10 - 1) // stride + 1, (18 - 1) // stride + 1)]
            assert ops.conv2d_wgrad(x, gp, 3, stride=stride, padding=1).shape == (m, 12, 3, 3)
        dw = ops.conv2d_wgrad([r(1, 16, 20, 36)], [r(1, 1, 10, 18), r(1, 8, 10, 18)], 4, stride=2, padding=1)
        assert dw.shape == (9, 16, 4, 4) and dw.dtype == torch.float32
        d_x = ops.conv3x3s2_input_grad(r(1, 128, 5, 9), r(128, 64, 3, 3))
        assert d_x.shape == (1, 64, 10, 18) and d_x.dtype == dtype
    names = [n for n, _ in stub.launched()]
    assert names == (["nct_wgrad_tc"] * 3 + ["nct_conv_tc"] if tc else ["nct_wgrad"] * 3 + ["nct_conv_transpose3x3s2"])
    if tc:
        assert stub.launched()[-1][1][8] == 3  # mode 3: the 3x3/s2 transpose conv
    want = {"wgrad_tc": 3, "conv_transpose3x3s2_tc": 1} if tc else {"wgrad": 3, "conv_transpose3x3s2": 1}
    assert kernels.launch_counts() == {k: want.get(k, 0) for k in kernels.LAUNCHES}


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_stride2_conv_function_backward_reaches_the_form_of_its_dtype(dtype):
    """A stride-2 conv's autograd Function: forward on K2 (``conv_tc`` in
    bf16), backward on the 3x3/s2 input-gradient form and K6 of its dtype."""
    g = torch.Generator().manual_seed(1)
    x = _r(g, 1, 8, 10, 18, dtype=dtype).requires_grad_()
    w = _r(g, 16, 8, 3, 3, dtype=dtype).requires_grad_()
    with stub_card():
        y = ops.conv3x3_trainable([x], w, None, stride=2)
        y.backward(torch.zeros_like(y))
    want = ({"conv_tc": 1, "conv_transpose3x3s2_tc": 1, "wgrad_tc": 1} if dtype == BF16
            else {"conv": 1, "conv_transpose3x3s2": 1, "wgrad": 1})
    assert kernels.launch_counts() == {k: want.get(k, 0) for k in kernels.LAUNCHES}
    assert x.grad.dtype == dtype and w.grad.dtype == dtype


def test_backward_forms_refuse_what_they_cannot_take():
    """Each wrapper raises before launching on a dtype or shape that is not
    its form's; the public functions route a dtype only to its own form."""
    g = torch.Generator().manual_seed(2)
    xb, x32 = _r(g, 1, 8, 10, 18, dtype=BF16), _r(g, 1, 8, 10, 18)
    gb = _r(g, 1, 4, 10, 18, dtype=BF16)
    cot = _r(g, 1, 128, 5, 9, dtype=BF16)
    with stub_card() as stub:
        for bad, err in (
            (lambda: convops._wgrad_tc_kernel([x32], [gb.float()], 3, 1, 1), TypeError),  # f32: wgrad
            (lambda: convops._wgrad_kernel([xb], [gb], 3, 1, 1), TypeError),  # bf16: wgrad_tc
            (lambda: convops._wgrad_tc_kernel([xb], [_r(g, 1, 4, 8, 16, dtype=BF16)], 5, 1, 1), ValueError),
            (lambda: convops._wgrad_tc_kernel([xb[:, :1]] * 5, [gb], 3, 1, 1), ValueError),  # 5 parts
            (lambda: convops._wgrad_tc_kernel([xb], [gb[:, :, :9]], 3, 1, 1), ValueError),  # not the conv's size
            (lambda: convops._conv_transpose3x3s2_tc_kernel(cot.float(), _r(g, 128, 64, 3, 3)), TypeError),
            (lambda: convops._conv_transpose3x3s2_kernel(cot, _r(g, 128, 64, 3, 3, dtype=BF16)), TypeError),
            (lambda: convops._conv_transpose3x3s2_tc_kernel(cot, _r(g, 128, 65, 3, 3, dtype=BF16)), ValueError),
            (lambda: ops.conv3x3s2_input_grad(cot, _r(g, 128, 64, 3, 3)), TypeError),  # mixed dtypes
        ):
            with pytest.raises(err):
                bad()
    assert stub.calls == [] and kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,m,b,h,w", [
    (3, 1, 1, 2, 37, 150), (3, 1, 40, 1, 20, 36), (3, 2, 128, 2, 37, 150), (3, 1, 65, 1, 44, 152),
    (4, 2, 33, 2, 19, 37), (4, 2, 65, 1, 20, 36),
])
def test_wgrad_tc_matches_plain_version(card, k, stride, m, b, h, w):
    """K6's tensor-core form on ragged tiles, x as two parts (the second a
    channel-offset view), M from 1 to 128; at k = 4 with the roles swapped
    (x the transpose conv's output cotangent, g its input parts [depth |
    features]). A repeat is bitwise equal."""
    gen = torch.Generator(device=card).manual_seed(k * m + h)
    r = lambda *s: torch.randn(*s, generator=gen, device=card).to(BF16)
    if k == 4:
        x = [r(b, 16, 2 * h, 2 * w), r(b, 30, 2 * h, 2 * w)[:, 7:]]
        gp = [r(b, 1, h, w), r(b, m - 1, h, w)]
    else:
        x = [r(b, 5, h, w), r(b, 70, h, w)[:, 3:]]
        gp = [r(b, m, (h - 1) // stride + 1, (w - 1) // stride + 1)]
    kernels.reset_launch_counts()
    got = ops.conv2d_wgrad(x, gp, k, stride=stride, padding=1)
    want = ops.conv2d_weight_grad_plain(x, gp, k, 1, stride=stride)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, ops.conv2d_wgrad(x, gp, k, stride=stride, padding=1))
    assert kernels.launch_counts()["wgrad_tc"] == 2 and kernels.launch_counts()["wgrad"] == 0


@pytest.mark.cuda
def test_wgrad_tc_is_bitwise_repeatable_at_full_resolution(card):
    """Many slices and a second pass: the same shape gives the same bits."""
    gen = torch.Generator(device=card).manual_seed(9)
    x = [torch.randn(1, 64, 176, 608, generator=gen, device=card).to(BF16)]
    gp = [torch.randn(1, 64, 176, 608, generator=gen, device=card).to(BF16)]
    first = ops.conv2d_wgrad(x, gp, 3, stride=1, padding=1)
    for _ in range(3):
        assert torch.equal(first, ops.conv2d_wgrad(x, gp, 3, stride=1, padding=1))
    assert _rel(first, ops.conv2d_weight_grad_plain(x, gp, 3, 1)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,b,h,w", [
    (128, 64, 1, 11, 38), (128, 32, 2, 9, 21), (24, 20, 2, 19, 76), (16, 8, 1, 5, 7), (128, 64, 1, 44, 152),
])
def test_conv_transpose3x3s2_tc_matches_plain_version(card, cin, cout, b, h, w):
    gen = torch.Generator(device=card).manual_seed(cin + cout + h)
    cot = torch.randn(b, cin, h, w, generator=gen, device=card).to(BF16)
    wt = (torch.randn(cin, cout, 3, 3, generator=gen, device=card) * (9 * cin) ** -0.5).to(BF16)
    kernels.reset_launch_counts()
    got = ops.conv3x3s2_input_grad(cot, wt)
    want = ops.conv3x3s2_input_grad_plain(cot, wt)
    assert got.dtype == BF16 and got.shape == (b, cout, 2 * h, 2 * w) and _rel(got, want) <= 5e-3
    counts = kernels.launch_counts()
    assert counts["conv_transpose3x3s2_tc"] == 1 and counts["conv_transpose3x3s2"] == 0
