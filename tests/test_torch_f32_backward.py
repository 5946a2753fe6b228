"""The f32 guided backward's two CUDA-core kernels: K6's weight cotangent
(``csrc/wgrad.cu``, counter ``wgrad``) and K2's K x K form (``convkxk_kernel``
of ``csrc/conv.cu``: the stride-1 input cotangent, counter ``conv_kxk``,
reading the forward weight flipped; the 4x4/s2 one, counter ``conv4x4s2``).

On the CPU:
  * routing, with the kernel library replaced by a stub that records each
    launch (``stub_card`` of tests/test_torch_backward_tc.py): f32 calls
    reach ``nct_wgrad`` and ``nct_conv_kxk``, each counted once; the stride-1
    input cotangent passes the forward weight as stored (no flipped copy),
    and a negative effective pad crops the cotangent
    as a view; every shape the plans tell apart (M = 1, cin 1 and 3, 33 and
    65 outputs, 4 parts, a channel-offset view) is accepted, and a call
    neither form takes raises before any launch;
  * the plain versions against the JAX package's backward at those edge
    shapes (Pallas in interpret mode): ``conv_filtergrad_pallas_bhcw`` and
    ``transpose_conv_bhcw`` within 1e-5, ``pallas_s2._ct_bwd``'s d_x and d_w
    within 1e-4 (its stride-2 selections, as tests/test_torch_guided_training.py).

On the card (``cuda``-marked, skipped here) each form against its plain
version at ragged shapes within 1e-5 rel RMSE (f32 sums in another order),
K6 bitwise repeatable at a full-resolution call, and the step-1 K x K
shapes. JAX is imported only by the tests that use it, so on the card this
file runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_f32_backward.py
"""
import numpy as np
import pytest
import torch

from nconv_tpu_torch import kernels, ops
from nconv_tpu_torch.ops import convops
from test_torch_backward_tc import stub_card

# nct_conv_kxk's arguments: (ptrs, meta, dtype, B, H, W, cin, ho, wo, cout,
# ksize, stride, pad, w, out, stream)
_H, _CIN, _COUT, _W = 4, 6, 9, 13
# nct_wgrad's: (g_ptrs, g_meta, ng, x_ptrs, x_meta, nx, dtype, B, M, cin, ...)
_NG, _NX, _M, _XC = 2, 5, 8, 9


def _r(g, *s):
    return torch.randn(*s, generator=g)


def _counts(**want):
    return {k: want.get(k, 0) for k in kernels.LAUNCHES}


def test_f32_input_grads_reach_the_kxk_form_with_the_weight_as_stored():
    """Stride 1: the forward weight (cin_fwd, cout_fwd, k, k) as stored; the
    1x1 pad-2 layer's cotangent cropped as a view; 4x4/s2: the transpose
    conv's weight as stored. Each counted once."""
    g = torch.Generator().manual_seed(20)
    w3, w1, w4 = _r(g, 64, 128, 3, 3), _r(g, 8, 8, 1, 1), _r(g, 65, 64, 4, 4)
    cot1 = _r(g, 2, 8, 13, 24)
    with stub_card() as stub:
        assert ops.conv2d_input_grad(_r(g, 1, 64, 9, 20), w3, 1).shape == (1, 128, 9, 20)
        assert ops.conv2d_input_grad(cot1, w1, 2).shape == (2, 8, 9, 20)
        assert ops.conv_transpose4x4s2_input_grad(_r(g, 1, 64, 19, 41), w4).shape == (1, 65, 9, 20)
    (n1, a1), (n2, a2), (n3, a3) = stub.launched()
    assert n1 == n2 == n3 == "nct_conv_kxk"
    assert (a1[_CIN], a1[_COUT], a1[_W]) == (64, 128, w3.data_ptr())
    assert (a2[_H], a2[_W]) == (9, w1.data_ptr())
    assert a2[0][0] == cot1[:, :, 2:, 2:].data_ptr()  # the crop is a view
    assert (a3[_CIN], a3[_COUT], a3[_W]) == (64, 65, w4.data_ptr())
    assert kernels.launch_counts() == _counts(conv_kxk=2, conv4x4s2=1)


@pytest.mark.parametrize("xc,gc,k,stride", [
    ((32,), (1,), 3, 1),            # M = 1: the heads
    ((1,), (32,), 3, 1),            # cin 1: the depth input
    ((3,), (64,), 3, 2),            # cin 3: the RGB frame, stride 2
    ((32,), (1, 32), 4, 2),         # M = 33: the transpose conv, roles swapped
    ((64,), (1, 64), 4, 2),         # M = 65
    ((8, "view", 8, 8), (64,), 3, 1),  # 4 parts, one a channel-offset view
])
def test_f32_wgrad_reaches_k6_at_every_plan_shape(xc, gc, k, stride):
    g = torch.Generator().manual_seed(21)
    h, w = 12, 20
    x = [_r(g, 1, 12, h, w)[:, 4:] if c == "view" else _r(g, 1, c, h, w) for c in xc]
    ho, wo = (h + 2 - k) // stride + 1, (w + 2 - k) // stride + 1
    gp = [_r(g, 1, c, ho, wo) for c in gc]
    with stub_card() as stub:
        dw = ops.conv2d_wgrad(x, gp, k, stride=stride, padding=1)
    (name, a), = stub.launched()
    assert name == "nct_wgrad" and dw.dtype == torch.float32
    assert (a[_NG], a[_NX], a[_M], a[_XC]) == (len(gc), len(xc), sum(gc), sum(p.shape[1] for p in x))
    assert dw.shape == (sum(gc), sum(p.shape[1] for p in x), k, k)
    assert kernels.launch_counts() == _counts(wgrad=1)


def test_f32_forms_refuse_what_they_cannot_take():
    g = torch.Generator().manual_seed(22)
    x, gp = _r(g, 1, 8, 10, 18), _r(g, 1, 4, 10, 18)
    up, w4 = _r(g, 1, 32, 18, 40), _r(g, 33, 32, 4, 4)
    with stub_card() as stub:
        for bad, err in (
            (lambda: convops._conv_kxk_kernel(up, _r(g, 33, 32, 3, 3), 1, 2), ValueError),  # 3x3 at stride 2
            (lambda: convops._conv_kxk_kernel(x, _r(g, 16, 8, 3, 3), 1, 1), ValueError),  # 16 != 8
            (lambda: convops._conv_kxk_kernel(x, _r(g, 8, 4, 2, 2), 0, 1), ValueError),  # k = 2
            (lambda: convops._conv_kxk_kernel(x.bfloat16(), _r(g, 8, 4, 3, 3).bfloat16(), 1, 1), TypeError),
            (lambda: convops._wgrad_kernel([x[:, :1]] * 5, [gp], 3, 1, 1), ValueError),  # 5 parts
            (lambda: convops._wgrad_kernel([x], [_r(g, 1, 4, 8, 16)], 5, 1, 1), ValueError),  # 5x5
            (lambda: convops._wgrad_kernel([x], [gp[:, :, :9]], 3, 1, 1), ValueError),  # not the conv's size
            (lambda: convops._wgrad_kernel([x.bfloat16()], [gp.bfloat16()], 3, 1, 1), TypeError),
        ):
            with pytest.raises(err):
                bad()
    assert stub.calls == [] and kernels.launch_counts() == _counts()


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's backward
# ---------------------------------------------------------------------------

def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _nchw(a):
    """(B, H, C, W) numpy -> (B, C, H, W) f32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 1, 3))))


def _split(t, sizes):
    return list(torch.split(t, list(sizes), 1))


@pytest.mark.parametrize("cin,m,parts", [(32, 1, (8, 8, 8, 8)), (1, 32, (1,)), (3, 64, (3,))])
def test_f32_stride1_plain_versions_match_the_pallas_backward(cin, m, parts):
    """K6's plain version against ``conv_filtergrad_pallas_bhcw`` (x in
    ``parts``) and the stride-1 input cotangent's against
    ``transpose_conv_bhcw``, at the plan's edge shapes: M = 1, cin 1 and 3."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from nconv_tpu.ops import pallas_conv

    rng = np.random.default_rng(cin + 7 * m)
    b, h, w = 2, 6, 16
    x = rng.standard_normal((b, h, cin, w)).astype(np.float32)
    g = rng.standard_normal((b, h, m, w)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, m)) * (9 * cin) ** -0.5).astype(np.float32)  # HWIO
    with pltpu.force_tpu_interpret_mode():
        dk = pallas_conv.conv_filtergrad_pallas_bhcw(jnp.asarray(x), jnp.asarray(g), kh=3, kw=3, padding=1)
        dx = pallas_conv.transpose_conv_bhcw(jnp.asarray(g), jnp.asarray(k), 1)
    dw = convops.conv2d_weight_grad_plain(_split(_nchw(x), parts), [_nchw(g)], 3, 1)
    assert _rel(dw.numpy(), np.transpose(np.asarray(dk), (3, 2, 0, 1))) <= 1e-5
    got = ops.conv2d_input_grad_plain(_nchw(g), torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()), 1)
    assert _rel(np.transpose(got.numpy(), (0, 2, 1, 3)), np.asarray(dx)) <= 1e-5


@pytest.mark.parametrize("cg,co", [(32, 33), (64, 65)])
def test_f32_4x4s2_plain_versions_match_the_pallas_backward(cg, co):
    """The 4x4/s2 transpose conv from [depth | fusion] parts of 1 and
    ``co`` - 1 channels to ``cg``: its input cotangent and, roles swapped,
    K6's weight cotangent against ``_ct_bwd``."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from nconv_tpu.ops import pallas_s2

    rng = np.random.default_rng(co)
    b, h, w = 2, 6, 16
    parts = [rng.standard_normal((b, h, c, w)).astype(np.float32) for c in (1, co - 1)]
    cot = rng.standard_normal((b, 2 * h, cg, 2 * w)).astype(np.float32)
    k = (rng.standard_normal((4, 4, co, cg)) * (4 * co) ** -0.5).astype(np.float32)  # (kh, kw, cin, cout)
    with pltpu.force_tpu_interpret_mode():
        d_parts, d_k, _ = pallas_s2._ct_bwd((tuple(jnp.asarray(p) for p in parts), jnp.asarray(k),
                                             jnp.zeros((cg,), jnp.float32)), jnp.asarray(cot))
    wt = torch.from_numpy(np.transpose(k, (2, 3, 0, 1)).copy())  # (cin, cout, 4, 4)
    d_x = ops.conv_transpose4x4s2_input_grad_plain(_nchw(cot), wt)
    assert _rel(np.transpose(d_x.numpy(), (0, 2, 1, 3)), np.concatenate([np.asarray(d) for d in d_parts], 2)) <= 1e-4
    dw = convops.conv2d_weight_grad_plain([_nchw(cot)], [_nchw(p) for p in parts], 4, 1, stride=2)
    assert dw.shape == (co, cg, 4, 4)
    assert _rel(dw.numpy(), np.transpose(np.asarray(d_k), (2, 3, 0, 1))) <= 1e-4


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
@pytest.mark.parametrize("h,w", [(20, 36), (37, 150)])
def test_f32_wgrad_matches_plain_version_at_every_plan_shape(card, h, w):
    """M = 1, cin 1 and 3, 33 and 65 outputs (roles swapped), 4 parts with a
    channel-offset view and a strided view; each within 1e-5 and bitwise
    repeatable."""
    g = torch.Generator(device=card).manual_seed(23)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    kernels.reset_launch_counts()
    x4 = [r(2, 7, h, w), r(2, 12, h, w)[:, 3:], r(2, 5, h, w + 3)[..., 1:w + 1], r(2, 1, h, w)]
    cases = [(x4, [r(2, 33, h, w)], 3, 1), (x4, [r(2, 1, h, w)], 3, 1), ([r(2, 1, h, w)], [r(2, 32, h, w)], 3, 1),
             ([r(2, 3, h, w)], [r(2, 64, (h + 1) // 2, (w + 1) // 2)], 3, 2),
             ([r(2, 32, 2 * h, 2 * w)], [r(2, 1, h, w), r(2, 32, h, w)], 4, 2),
             ([r(2, 64, 2 * h, 2 * w)], [r(2, 1, h, w), r(2, 64, h, w)], 4, 2)]
    for xs, gs, k, stride in cases:
        dw = ops.conv2d_wgrad(xs, gs, k, stride=stride, padding=1)
        assert _rel_t(dw, convops.conv2d_weight_grad_plain(xs, gs, k, 1, stride=stride)) <= 1e-5
        assert torch.equal(dw, ops.conv2d_wgrad(xs, gs, k, stride=stride, padding=1))
    assert kernels.launch_counts()["wgrad"] == 2 * len(cases)


@pytest.mark.cuda
def test_f32_wgrad_is_bitwise_repeatable_at_full_resolution(card):
    """[32, 64, 3, 3] at 352x1216, the guided step's widest level-0 call."""
    g = torch.Generator(device=card).manual_seed(24)
    x = [torch.randn(1, 64, 352, 1216, generator=g, device=card)]
    gp = [torch.randn(1, 32, 352, 1216, generator=g, device=card)]
    first = ops.conv2d_wgrad(x, gp, 3, padding=1)
    assert all(torch.equal(first, ops.conv2d_wgrad(x, gp, 3, padding=1)) for _ in range(3))
    assert _rel_t(first, convops.conv2d_weight_grad_plain(x, gp, 3, 1)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(20, 36), (37, 150)])
def test_f32_kxk_forms_match_plain_versions(card, h, w):
    """The stride-1 input cotangent (forward weight read flipped) at 1 -> 32,
    33 -> 64 (odd), 64 -> 128 and 16 -> 40 (three slabs) channels, from a
    strided cotangent view; the 4x4/s2 one at 32 -> 33 and 64 -> 65."""
    g = torch.Generator(device=card).manual_seed(25)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    kernels.reset_launch_counts()
    for cg, co in ((1, 32), (33, 64), (64, 128), (16, 40)):
        cot = r(2, cg, h, w + 5)[..., 2:w + 2]
        wf = r(cg, co, 3, 3)
        assert _rel_t(ops.conv2d_input_grad(cot, wf, 1), ops.conv2d_input_grad_plain(cot, wf, 1)) <= 1e-5
    for cg, co in ((32, 33), (64, 65)):
        up, wt = r(2, cg, 2 * h, 2 * w), r(co, cg, 4, 4)
        assert _rel_t(ops.conv_transpose4x4s2_input_grad(up, wt),
                      ops.conv_transpose4x4s2_input_grad_plain(up, wt)) <= 1e-5
    counts = kernels.launch_counts()
    assert (counts["conv_kxk"], counts["conv4x4s2"]) == (4, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,p,cg,co", [(5, 2, 8, 8), (3, 1, 16, 8), (3, 1, 8, 16), (1, 2, 8, 8)])
def test_step1_kxk_shapes_match_plain_versions(card, k, p, cg, co):
    """Step 1's input cotangents at B = 4, 8 and 16 channels, 88x304: 5x5,
    3x3 and the 1x1 pad-2 layer (its cotangent cropped)."""
    g = torch.Generator(device=card).manual_seed(26)
    h, w = 88, 304
    cot = torch.randn(4, cg, h + 2 * p - k + 1, w + 2 * p - k + 1, generator=g, device=card)
    wf = torch.randn(cg, co, k, k, generator=g, device=card)
    kernels.reset_launch_counts()
    got = ops.conv2d_input_grad(cot, wf, p)
    assert got.shape == (4, co, h, w)
    assert _rel_t(got, ops.conv2d_input_grad_plain(cot, wf, p)) <= 1e-5
    assert kernels.launch_counts()["conv_kxk"] == 1
