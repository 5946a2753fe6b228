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


# nct_conv_tc's arguments: (ptrs, meta, nparts, B, H, W, cin, cout, mode, w,
# w_dtype, w_flip, wsc, bias, bias_dtype, out, relu, centre, stream)
_MODE, _CENTRE = 8, 17


def _centre_only(w, n):
    """``w`` (cin, cout, 3, 3) with its last ``n`` rows zero outside the
    centre tap, as the residual backward stacks the 1x1 shortcut."""
    w = w.clone()
    w[w.shape[0] - n:, :, [0, 0, 0, 1, 1, 2, 2, 2], [0, 1, 2, 0, 2, 0, 1, 2]] = 0
    return w


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_t3_centre_count_routes_and_leaves_the_result(dtype):
    """``conv3x3s2_input_grad``'s ``centre``: the bf16 call hands it to mode 3
    of ``nct_conv_tc`` (0 by default), the f32 call reaches K3's CUDA-core
    form as before; on the CPU the plain version gives the same result with
    and without it."""
    g = torch.Generator().manual_seed(19)
    cot, w = _r(g, 1, 12, 5, 9, dtype=dtype), _centre_only(_r(g, 12, 8, 3, 3, dtype=dtype), 4)
    with stub_card() as stub:
        ops.conv3x3s2_input_grad(cot, w, 4)
        ops.conv3x3s2_input_grad(cot, w)
    (n1, a1), (n2, a2) = stub.launched()
    if dtype == BF16:
        assert n1 == n2 == "nct_conv_tc" and (a1[_MODE], a1[_CENTRE], a2[_CENTRE]) == (3, 4, 0)
    else:
        assert n1 == n2 == "nct_conv_transpose3x3s2"
    plain = ops.conv3x3s2_input_grad(cot, w)
    assert torch.equal(ops.conv3x3s2_input_grad(cot, w, 4), plain)
    assert torch.equal(ops.conv3x3s2_input_grad_plain(cot, w, 11), ops.conv3x3s2_input_grad_plain(cot, w))


@pytest.mark.parametrize("centre", [-1, 12, 13, 1.5, True, None])
def test_t3_centre_count_refuses_bad_values(centre):
    """A count outside [0, cin) or not an int raises before any launch, on
    the card's path and the plain one."""
    g = torch.Generator().manual_seed(20)
    cot, w = _r(g, 1, 12, 5, 9, dtype=BF16), _r(g, 12, 8, 3, 3, dtype=BF16)
    with stub_card() as stub:
        with pytest.raises(ValueError):
            ops.conv3x3s2_input_grad(cot, w, centre)
        with pytest.raises(ValueError):
            ops.conv3x3s2_input_grad(cot.float(), w.float(), centre)
    assert stub.calls == []
    with pytest.raises(ValueError):
        ops.conv3x3s2_input_grad_plain(cot, w, centre)


def test_residual_backward_passes_the_shortcuts_channels_as_centre_only():
    """The stride-2 residual conv's backward: the cotangent [gm | g] against
    [weight ; shortcut at the centre tap], so g's channels (cout of them)
    are centre-only."""
    g = torch.Generator().manual_seed(21)
    x = _r(g, 1, 8, 10, 18, dtype=BF16).requires_grad_()
    w, sc = _r(g, 16, 8, 3, 3, dtype=BF16).requires_grad_(), _r(g, 16, 8, 1, 1, dtype=BF16).requires_grad_()
    with stub_card() as stub:
        y = ops.conv3x3_residual_trainable([x], w, None, sc, stride=2)
        y.backward(torch.zeros_like(y))
    t3 = [a for n, a in stub.launched() if n == "nct_conv_tc" and a[_MODE] == 3]
    assert len(t3) == 1 and (t3[0][6], t3[0][_CENTRE]) == (32, 16)


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
@pytest.mark.parametrize("k,stride,m,xc,b,h,w", [
    # M 1 to 130 (wgmma widths 8, 32, 40, 64, 72, 128 and two column groups),
    # x as parts, the last a channel-offset view
    (3, 1, 1, (5, 67), 2, 37, 150), (3, 1, 40, (5, 67), 1, 20, 36), (3, 2, 128, (5, 67), 2, 37, 150),
    (3, 1, 65, (5, 67), 1, 44, 152), (3, 1, 33, (32,), 1, 9, 40), (3, 1, 130, (16, 16), 1, 12, 33),
    # cin 1 and 3: D's rows mostly padding
    (3, 1, 32, (1,), 2, 13, 70), (3, 1, 64, (3,), 1, 22, 76), (3, 2, 64, (1,), 1, 23, 61),
    # the consumers' m-tiles: 1 to 5 a warpgroup, several blocks over them
    (3, 1, 32, (32, 32), 1, 16, 64), (3, 1, 8, (64, 64, 16), 1, 11, 40), (3, 1, 64, (64, 64), 1, 22, 76),
    (3, 2, 128, (64,), 1, 22, 76),
    # 4x4/s2, roles swapped: x the transpose conv's output cotangent (even
    # and odd sizes: both column parities ragged), g its input parts
    (4, 2, 33, (16, 23), 2, 19, 37), (4, 2, 65, (16, 23), 1, 20, 36), (4, 2, 65, (64,), 1, 11, 38),
    (4, 2, 2, (8,), 1, 5, 9),
])
def test_wgrad_tc_matches_plain_version(card, k, stride, m, xc, b, h, w):
    """K6's tensor-core form on ragged tiles against its plain version within
    1e-5; rows that are not 16-byte aligned (odd widths, a channel-offset
    view) and aligned ones. A repeat is bitwise equal."""
    gen = torch.Generator(device=card).manual_seed(k * m + h + sum(xc))
    r = lambda *s: torch.randn(*s, generator=gen, device=card).to(BF16)
    if k == 4:
        hx, wx = 2 * h, 2 * w
        gp = [r(b, 1, h, w), r(b, m - 1, h, w)] if m > 1 else [r(b, 1, h, w)]
    else:
        hx, wx = h, w
        gp = [r(b, m, (h - 1) // stride + 1, (w - 1) // stride + 1)]
    x = [r(b, c, hx, wx) for c in xc[:-1]] + [r(b, xc[-1] + 3, hx, wx)[:, 3:]]
    kernels.reset_launch_counts()
    got = ops.conv2d_wgrad(x, gp, k, stride=stride, padding=1)
    want = ops.conv2d_weight_grad_plain(x, gp, k, 1, stride=stride)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, ops.conv2d_wgrad(x, gp, k, stride=stride, padding=1))
    assert kernels.launch_counts()["wgrad_tc"] == 2 and kernels.launch_counts()["wgrad"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,cin,h,w", [(64, 64, 176, 608), (32, 32, 352, 1216)])
def test_wgrad_tc_is_bitwise_repeatable_at_full_resolution(card, m, cin, h, w):
    """Many slices and a second pass: the same shape gives the same bits,
    within 1e-5 of the plain version (the guided step's 176x608 64 x 64 call
    and its full-resolution 32 x 32 one)."""
    gen = torch.Generator(device=card).manual_seed(9)
    x = [torch.randn(1, cin, h, w, generator=gen, device=card).to(BF16)]
    gp = [torch.randn(1, m, h, w, generator=gen, device=card).to(BF16)]
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


# the bf16 guided step's three calls: the RGB encoder's stride-2 residual
# convs, cotangent [gm | g] of 128 channels against [weight ; shortcut]
_T3_CALLS = [(32, 176, 608), (64, 88, 304), (64, 44, 152)]


@pytest.mark.cuda
@pytest.mark.parametrize("cout,h,w", _T3_CALLS)
def test_conv_transpose3x3s2_tc_at_the_guided_steps_calls(card, cout, h, w):
    """Each call with its 64 centre-only channels against the plain version,
    bitwise equal to the generic form (the skipped products are zeros) and
    to a second launch."""
    gen = torch.Generator(device=card).manual_seed(cout + h)
    cot = torch.randn(1, 128, h, w, generator=gen, device=card).to(BF16)
    wt = _centre_only((torch.randn(128, cout, 3, 3, generator=gen, device=card) * (9 * 128) ** -0.5).to(BF16), 64)
    kernels.reset_launch_counts()
    got, again, generic = (ops.conv3x3s2_input_grad(cot, wt, c) for c in (64, 64, 0))
    assert kernels.launch_counts()["conv_transpose3x3s2_tc"] == 3
    assert got.shape == (1, cout, 2 * h, 2 * w) and _rel(got, ops.conv3x3s2_input_grad_plain(cot, wt)) <= 5e-3
    assert torch.equal(got, generic) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,centre,cout,b,h,w", [
    (40, 8, 24, 3, 7, 13),    # B 3, W odd, a centre count that is not a multiple of 16
    (128, 64, 64, 2, 5, 21),  # two images, a ragged tile
    (24, 23, 8, 1, 9, 40),    # one channel outside the centre-only ones
    (96, 0, 40, 1, 6, 17),    # the generic form at 40 outputs (64 columns)
    (48, 16, 64, 2, 9, 24),   # 64 columns, k16 steps a tap by count
    (64, 8, 64, 1, 12, 33),   # 64-channel chains at 64 columns, W odd
])
def test_conv_transpose3x3s2_tc_centre_count_ragged(card, cin, centre, cout, b, h, w):
    gen = torch.Generator(device=card).manual_seed(cin + centre + h)
    cot = torch.randn(b, cin, h, w, generator=gen, device=card).to(BF16)
    wt = _centre_only((torch.randn(cin, cout, 3, 3, generator=gen, device=card) * (9 * cin) ** -0.5).to(BF16),
                      centre)
    got, generic = ops.conv3x3s2_input_grad(cot, wt, centre), ops.conv3x3s2_input_grad(cot, wt)
    assert _rel(got, ops.conv3x3s2_input_grad_plain(cot, wt)) <= 5e-3 and torch.equal(got, generic)
