"""The tensor-core forms of K2 and K3 (``csrc/conv_tc.cu``) and the residual
conv's backward.

On the CPU:
  * form routing: the mixed serving frame sends its 18 bf16 convs with 8 or
    more output channels to ``conv_tc``, its 3 transpose convs to
    ``conv_transpose_tc``, its u8 encoder and 4 heads to ``conv_thin`` and
    its 4 chains to ``conv_chain_tc``; the f32 frame sends none there. The
    wrappers' kernels are replaced by counting stand-ins that return the
    plain result, so the routing code of ``ops/convops.py`` is what runs;
  * the bf16 weight contract: on bf16 parts the plain versions round an f32
    weight to bf16 (nearest even) exactly as JAX's mixed schedule casts
    ``kernel.astype(bf16)``: the output equals the one from the pre-rounded
    weight bit for bit, differs from the unrounded one, and stands within
    4e-3 rel RMSE (about one bf16 ulp, the bar of
    tests/test_torch_bf16_training.py) of the JAX package's Pallas convs (in
    interpret mode) on the same bf16 operands;
  * the residual form's backward against ``jax.vjp`` of
    ``conv2d_pallas_bhcw(..., residual_channels=n)`` in interpret mode: f32
    within 1e-5; bf16 no further from JAX f32 than 2x JAX bf16's own
    distance (the recovered ReLU mask can flip in bf16, in both).

On the card (``cuda``-marked, skipped here): each tensor-core form against
its plain version at ragged shapes within 5e-3 rel RMSE (bf16 output
rounding): ragged last tiles, odd sizes at stride 2, parts of different
widths and strided views, cout 8-128 with and without the shortcut, each
transpose parity; and the calls it refuses raise. JAX is imported only by the
tests that use it, so on the card this file runs as tests/test_torch_kernels.py
does:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conv_tc.py
"""
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nconv_tpu_torch import kernels, ops
from nconv_tpu_torch.models import GuidedDepthNet
from nconv_tpu_torch.ops import convops, nconv
from nconv_tpu_torch.runtime import StreamingEngine

BF16 = torch.bfloat16
BF16_BAR = 5e-3


def _jax():
    """jax, jax.numpy, Pallas's TPU module and the JAX package's conv modules."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from nconv_tpu.ops import pallas_conv, pallas_s2

    return jax, jnp, pltpu, pallas_conv, pallas_s2


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def bhcw_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 2, 1, 3))))


def nchw_to_bhcw(t):
    return np.transpose(t.detach().numpy(), (0, 2, 1, 3))


def hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))


def hwio_to_iohw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (2, 3, 0, 1))))


def leaf(t):
    return t.detach().clone().requires_grad_()


# ---------------------------------------------------------------------------
# Form routing of the serving frame
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counting_kernels():
    """Every kernel wrapper as if its tensors were on the card, each kernel
    replaced by a stand-in that notes (form, call) and returns the plain
    result."""
    calls = []

    def stand_in(form, plain):
        def run(*args):
            calls.append((form, args))
            return plain(*args)
        return run

    fakes = {
        (nconv, "_nconv2d_kernel"): stand_in("nconv", lambda d, c, w, b, padding, up2, crop, pool_out, eps:
                                             nconv.nconv2d_fused_plain(d, c, w, b, padding=padding, up2=up2,
                                                                       crop=crop, pool_out=pool_out, eps=eps)),
        (convops, "_conv3x3_kernel"): stand_in("conv", lambda p, w, b, s, r, sc, od: convops.conv3x3_plain(
            p, w, b, stride=s, relu=r, shortcut=sc, out_dtype=od)),
        (convops, "_conv_tc_kernel"): stand_in("conv_tc", lambda p, w, b, s, r, sc: convops.conv3x3_plain(
            p, w, b, stride=s, relu=r, shortcut=sc, out_dtype=BF16)),
        (convops, "_conv_thin_kernel"): stand_in("conv_thin", lambda p, w, b, r, sc: convops.conv3x3_plain(
            p, w, b, relu=r, shortcut=sc, out_dtype=BF16)),
        (convops, "_conv_transpose_kernel"): stand_in("conv_transpose", lambda p, w, b, r:
                                                      convops.conv_transpose4x4s2_plain(p, w, b, relu=r)),
        (convops, "_conv_transpose_tc_kernel"): stand_in("conv_transpose_tc", lambda p, w, b, r:
                                                         convops.conv_transpose4x4s2_plain(p, w, b, relu=r)),
        (convops, "_chain_kernel"): stand_in("conv_chain", convops.conv3x3_chain2_plain),
        (convops, "_chain_tc_kernel"): stand_in("conv_chain_tc", convops.conv3x3_chain2_plain),
    }
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(kernels, "on_card", lambda *t: True))
        for (mod, name), fake in fakes.items():
            stack.enter_context(mock.patch.object(mod, name, fake))
        yield calls


PER_FRAME = {
    torch.bfloat16: {"conv_tc": 18, "conv_thin": 5, "conv_transpose_tc": 3, "nconv": 9, "conv_chain_tc": 4},
    torch.float32: {"conv": 23, "conv_transpose": 3, "nconv": 9, "conv_chain": 4},
}


def _frame(h, w, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        d = (rng.random((h, w)) * 80 * (rng.random((h, w)) < 0.06)).astype(np.float32)
        out += [rgb, d]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["mixed", "f32"])
def test_serving_frame_routes_its_convs_to_the_stated_forms(dtype):
    h, w = 96, 128
    eng = StreamingEngine(GuidedDepthNet(device="cpu", seed=0).state_dict(), height=h, width=w, device="cpu",
                          compute_dtype=dtype)
    with counting_kernels() as calls, torch.no_grad():
        eng(*_frame(h, w))
    counts = {}
    for form, _ in calls:
        counts[form] = counts.get(form, 0) + 1
    assert counts == PER_FRAME[dtype]
    for form, args in calls:
        if form in ("conv", "conv_tc", "conv_thin"):
            parts, weight, out_dtype = args[0], args[1], (args[6] if form == "conv" else BF16)
            stride = 1 if form == "conv_thin" else args[3]
            tc = ops.on_tensor_cores(parts[0].dtype, out_dtype, weight.shape[0])
            thin = ops.on_thin(parts[0].dtype, out_dtype, weight.shape[0], stride)
            assert (tc, thin) == (form == "conv_tc", form == "conv_thin"), (form, parts[0].dtype, out_dtype,
                                                                            tuple(weight.shape))
            assert tc == (parts[0].dtype == BF16 and out_dtype == BF16 and weight.shape[0] >= 8)
            assert thin == (out_dtype == BF16 and stride == 1 and (parts[0].dtype == torch.uint8 or (
                parts[0].dtype == BF16 and weight.shape[0] < 8)))
        elif form in ("conv_transpose", "conv_transpose_tc"):
            assert (args[0][0].dtype == BF16) == (form == "conv_transpose_tc")
        elif form in ("conv_chain", "conv_chain_tc"):
            assert (args[0].dtype == BF16) == (form == "conv_chain_tc")
    # the 26 K2 and K3 calls of the frame, by signature
    k2 = [(len(a[0]), sum(p.shape[1] for p in a[0]), a[1].shape[0], 1 if f == "conv_thin" else a[3])
          for f, a in calls if f in ("conv", "conv_tc", "conv_thin")]
    k3 = [(len(a[0]), sum(p.shape[1] for p in a[0]), a[1].shape[1]) for f, a in calls
          if f.startswith("conv_transpose")]
    assert len(k2) == 23 and len(k3) == 3
    assert sorted(k3) == [(2, 33, 32), (2, 65, 64), (2, 65, 64)]
    assert sum(1 for _, _, cout, s in k2 if s == 2) == 3
    assert sum(1 for _, _, cout, _ in k2 if cout == 1) == 4
    if dtype == BF16:  # the thin calls: the u8 encoder (3 -> 32) and the 4 heads (64, 64, 32, 32 -> 1)
        thin = sorted((sum(p.shape[1] for p in a[0]), a[1].shape[0], a[0][0].dtype == torch.uint8) for f, a in calls
                      if f == "conv_thin")
        assert thin == [(3, 32, True), (32, 1, False), (32, 1, False), (64, 1, False), (64, 1, False)]


def test_tc_routing_rule():
    assert ops.on_tensor_cores(BF16, BF16, 8)
    assert not ops.on_tensor_cores(BF16, BF16, 7)
    assert not ops.on_tensor_cores(BF16, torch.float32, 64)
    assert not ops.on_tensor_cores(torch.float32, torch.float32, 64)
    assert not ops.on_tensor_cores(torch.uint8, BF16, 32)


# ---------------------------------------------------------------------------
# The bf16 weight contract of the plain versions, against nconv_tpu
# ---------------------------------------------------------------------------

def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _jax_bf16(fn, *args):
    """``fn`` on bf16 operands (Pallas in interpret mode), as f32 numpy."""
    jax, jnp, pltpu, _, _ = _jax()
    with pltpu.force_tpu_interpret_mode():
        out = fn(*jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), args))
    return np.asarray(out.astype(jnp.float32))


def _contract(port, got_rounded, got_unrounded, want):
    """``port`` (the plain version on an unrounded f32 weight) equals the
    pre-rounded weight's output, differs from the unrounded weight's, and is
    within 4e-3 of JAX."""
    assert port.dtype == BF16
    assert torch.equal(port, got_rounded)
    assert not torch.equal(port, got_unrounded)
    assert rel(nchw_to_bhcw(port.float()), want) <= 4e-3


def _unrounded_conv(parts, w, b, **kw):
    x = torch.cat([p.float() for p in parts], 1)
    return F.conv2d(x, w, b, padding=1, **kw)


@pytest.mark.parametrize("case", ["two_parts", "cin65_1_64", "strided_view", "odd_hw"])
def test_plain_conv_rounds_weights_as_jax_bf16(case):
    rng = np.random.default_rng(["two_parts", "cin65_1_64", "strided_view", "odd_hw"].index(case))
    h, w = (7, 9) if case == "odd_hw" else (8, 16)
    chans = {"two_parts": (8, 16), "cin65_1_64": (1, 64), "strided_view": (8, 12), "odd_hw": (5, 11)}[case]
    f = 16
    parts = [_bf16(rng.standard_normal((2, h, c, w))) for c in chans]
    k = (rng.standard_normal((3, 3, sum(chans), f)) * 0.2).astype(np.float32)  # not bf16-valued
    b = _bf16(rng.standard_normal(f))
    conv_cat = _jax()[3].conv2d_pallas_bhcw_cat
    want = _jax_bf16(lambda ps, kk, bb: conv_cat(ps, kk, bb, padding=1, relu=True),
                     parts, _bf16(k), b)
    tp = [bhcw_to_nchw(p).to(BF16) for p in parts]
    if case == "strided_view":  # the second part as a channel slice of a wider tensor
        wide = torch.zeros(2, chans[1] + 6, h, w, dtype=BF16)
        wide[:, 3:3 + chans[1]] = tp[1]
        tp[1] = wide[:, 3:3 + chans[1]]
    tk, tb = hwio_to_oihw(k), torch.from_numpy(b)
    port = ops.conv3x3_plain(tp, tk, tb, relu=True, out_dtype=BF16)
    rounded = ops.conv3x3_plain(tp, tk.to(BF16).float(), tb, relu=True, out_dtype=BF16)
    unrounded = torch.relu(_unrounded_conv(tp, tk, tb)).to(BF16)
    _contract(port, rounded, unrounded, want)


def test_plain_stride2_residual_rounds_weights_as_jax_bf16():
    """relu(conv3x3_s2 + b) + conv1x1_s2 against JAX's stacked encoder pair
    ``[conv3x3_s2 + b | conv1x1_s2]`` on the same bf16 operands, whose two
    halves are each rounded to bf16 before the port's one rounding of the
    sum: so the bar here is 2x one ulp."""
    rng = np.random.default_rng(7)
    c, f, h, w = 8, 16, 10, 14
    x = _bf16(rng.standard_normal((2, h, c, w)))
    km = (rng.standard_normal((3, 3, c, f)) * 0.2).astype(np.float32)
    ks = (rng.standard_normal((1, 1, c, f)) * 0.2).astype(np.float32)
    b = _bf16(rng.standard_normal(f))
    pair = _jax_bf16(_jax()[4].conv2d_s2_res_pallas_bhcw, x, _bf16(km), _bf16(ks), b)
    want = np.maximum(pair[:, :, :f], 0) + pair[:, :, f:]
    tx, tkm, tks, tb = bhcw_to_nchw(x).to(BF16), hwio_to_oihw(km), hwio_to_oihw(ks), torch.from_numpy(b)
    port = ops.conv3x3_plain([tx], tkm, tb, stride=2, relu=True, shortcut=tks, out_dtype=BF16)
    rounded = ops.conv3x3_plain([tx], tkm.to(BF16).float(), tb, stride=2, relu=True,
                                shortcut=tks.to(BF16).float(), out_dtype=BF16)
    assert torch.equal(port, rounded)
    unrounded = (torch.relu(_unrounded_conv([tx], tkm, tb, stride=2))
                 + F.conv2d(tx.float(), tks, stride=2)).to(BF16)
    assert not torch.equal(port, unrounded)
    assert rel(nchw_to_bhcw(port.float()), want) <= 8e-3


@pytest.mark.parametrize("chans,h,w", [((1, 64), 5, 7), ((1, 32), 4, 6)])
def test_plain_transpose_conv_rounds_weights_as_jax_bf16(chans, h, w):
    rng = np.random.default_rng(sum(chans) + h)
    f = chans[1]
    parts = [_bf16(rng.standard_normal((2, h, c, w))) for c in chans]
    k = (rng.standard_normal((4, 4, sum(chans), f)) * 0.1).astype(np.float32)
    b = _bf16(rng.standard_normal(f))
    want = _jax_bf16(_jax()[4].convtranspose2d_s2_pallas_bhcw, parts, _bf16(k), b)
    tp = [bhcw_to_nchw(p).to(BF16) for p in parts]
    tk, tb = hwio_to_iohw(k), torch.from_numpy(b)
    port = ops.conv_transpose4x4s2_plain(tp, tk, tb, relu=False)
    rounded = ops.conv_transpose4x4s2_plain(tp, tk.to(BF16).float(), tb, relu=False)
    unrounded = F.conv_transpose2d(torch.cat([p.float() for p in tp], 1), tk, tb, stride=2,
                                   padding=1).to(BF16)
    _contract(port, rounded, unrounded, want)


@pytest.mark.parametrize("chans,h,w", [((1, 64), 5, 7), ((1, 32), 4, 6)])
def test_plain_transpose_conv_matches_pallas_f32(chans, h, w):
    """K3's f32 plain version, which the 4x4/s2 f32 kernel is held to, on
    UpCat's [depth | fusion] parts against the Pallas transpose conv
    (interpret mode) at 1e-5."""
    jax, jnp, pltpu, _, pallas_s2 = _jax()
    rng = np.random.default_rng(100 + sum(chans) + h)
    f = chans[1]
    parts = [rng.standard_normal((2, h, c, w)).astype(np.float32) for c in chans]
    k = (rng.standard_normal((4, 4, sum(chans), f)) * 0.1).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_s2.convtranspose2d_s2_pallas_bhcw([jnp.asarray(p) for p in parts], jnp.asarray(k),
                                                                   jnp.asarray(b)))
    got = ops.conv_transpose4x4s2_plain([bhcw_to_nchw(p) for p in parts], hwio_to_iohw(k), torch.from_numpy(b),
                                        relu=False)
    assert got.dtype == torch.float32 and got.shape == (2, f, 2 * h, 2 * w)
    assert rel(nchw_to_bhcw(got), want) <= 1e-5


# ---------------------------------------------------------------------------
# The residual form's backward against the Pallas custom VJP
# ---------------------------------------------------------------------------

def _residual_case(c, n, h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, c, w)).astype(np.float32)
    km = (rng.standard_normal((3, 3, c, n)) * 0.2).astype(np.float32)
    ks = (rng.standard_normal((c, n)) * 0.2).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    cot = rng.standard_normal((2, h, n, w)).astype(np.float32)
    return x, km, ks, b, cot


def _stacked(km, ks):
    """JAX's residual kernel [main | shortcut] with the 1x1 shortcut as the
    centre tap of the second half (HWIO)."""
    c, n = ks.shape
    sk = np.zeros((3, 3, c, n), np.float32)
    sk[1, 1] = ks
    return np.concatenate([km, sk], -1)


def _jax_residual(x, km, ks, b, cot, dtype):
    """Output and (d_x, d_w, d_shortcut, d_b) of JAX's residual form, ``dtype``
    a name of jax.numpy's (``"float32"``, ``"bfloat16"``)."""
    jax, jnp, pltpu, pallas_conv, _ = _jax()
    dtype = getattr(jnp, dtype)
    n = km.shape[-1]
    fn = lambda xx, kk, bb: pallas_conv.conv2d_pallas_bhcw(xx, kk, bb, padding=1, residual_channels=n)
    args = [jnp.asarray(a, dtype) for a in (x, _stacked(km, ks), b)]
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fn, *args)
        d_x, d_k, d_b = vjp(jnp.asarray(cot, dtype))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    d_k = f32(d_k)
    return f32(out), f32(d_x), d_k[..., :n], d_k[1, 1, :, n:], f32(d_b)


def _port_residual(x, km, ks, b, cot, dtype):
    tx, tkm, tb = (leaf(t.to(dtype)) for t in (bhcw_to_nchw(x), hwio_to_oihw(km), torch.from_numpy(b)))
    tks = leaf(torch.from_numpy(np.ascontiguousarray(ks.T)).reshape(ks.shape[1], ks.shape[0], 1, 1).to(dtype))
    out = ops.conv3x3_residual_trainable([tx], tkm, tb, tks)
    out.backward(bhcw_to_nchw(cot).to(dtype))
    assert out.dtype == dtype and all(t.grad.dtype == dtype for t in (tx, tkm, tb, tks))
    to_hwio = lambda t: np.transpose(t.detach().float().numpy(), (2, 3, 1, 0))
    return (nchw_to_bhcw(out.float()), nchw_to_bhcw(tx.grad.float()), to_hwio(tkm.grad),
            tks.grad.float().reshape(tks.shape[0], -1).numpy().T, tb.grad.float().numpy())


NAMES = ("out", "d_x", "d_w", "d_shortcut", "d_b")


@pytest.mark.parametrize("c,n,h,w", [(8, 8, 8, 16), (3, 16, 12, 20)])
def test_residual_backward_matches_pallas_vjp_f32(c, n, h, w):
    case = _residual_case(c, n, h, w, c + h)
    want = _jax_residual(*case, "float32")
    got = _port_residual(*case, torch.float32)
    for name, g_, w_ in zip(NAMES, got, want):
        assert rel(g_, w_) <= 1e-5, name


@pytest.mark.parametrize("c,n,h,w", [(8, 8, 8, 16), (3, 16, 12, 20)])
def test_residual_backward_bf16_stands_within_2x_jax_bf16(c, n, h, w):
    x, km, ks, b, cot = _residual_case(c, n, h, w, 40 + c + h)
    x, km, ks, b, cot = (_bf16(a) for a in (x, km, ks, b, cot))
    want32 = _jax_residual(x, km, ks, b, cot, "float32")
    want16 = _jax_residual(x, km, ks, b, cot, "bfloat16")
    got = _port_residual(x, km, ks, b, cot, BF16)
    for name, g_, w32, w16 in zip(NAMES, got, want32, want16):
        assert rel(g_, w32) <= 2 * rel(w16, w32), (name, rel(g_, w32), rel(w16, w32))


def test_residual_backward_equals_autograd_of_the_plain_composite_f64():
    """The Function's gradient against torch autograd of ``relu(conv + b) +
    conv1x1`` in f64 at stride 1 and 2, over two parts."""
    g = torch.Generator().manual_seed(9)
    for stride in (1, 2):
        parts = [torch.randn(2, c, 9, 13, generator=g, dtype=torch.float64) for c in (3, 5)]
        w = torch.randn(6, 8, 3, 3, generator=g, dtype=torch.float64) * 0.3
        b = torch.randn(6, generator=g, dtype=torch.float64)
        sc = torch.randn(6, 8, 1, 1, generator=g, dtype=torch.float64) * 0.3
        leaves = [leaf(t) for t in (*parts, w, b, sc)]
        out = ops.conv3x3_residual_trainable(leaves[:2], *leaves[2:4], leaves[4], stride=stride)
        cot = torch.randn(out.shape, generator=g, dtype=torch.float64)
        got = torch.autograd.grad(out, leaves, cot)
        ref_leaves = [leaf(t) for t in (*parts, w, b, sc)]
        x = torch.cat(ref_leaves[:2], 1)
        ref = (torch.relu(F.conv2d(x, ref_leaves[2], ref_leaves[3], stride=stride, padding=1))
               + F.conv2d(x, ref_leaves[4], stride=stride))
        want = torch.autograd.grad(ref, ref_leaves, cot)
        assert torch.allclose(out, ref, rtol=1e-12, atol=1e-12)
        for a, e in zip(got, want):
            assert torch.allclose(a, e, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _close(a, b, bar=BF16_BAR):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm()) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("chans,cout,stride,res,h,w", [
    ((64,), 64, 1, False, 23, 37), ((64, 64), 64, 1, False, 17, 45), ((1,), 64, 1, False, 21, 30),
    ((32, 32), 32, 1, False, 19, 70), ((5, 3), 8, 1, False, 9, 11), ((16,), 16, 2, False, 20, 36),
    ((32,), 64, 2, True, 22, 70), ((64,), 64, 2, True, 21, 33), ((24,), 32, 1, True, 13, 29),
    ((3,), 64, 1, False, 12, 20), ((64,), 128, 2, False, 18, 34), ((20,), 40, 1, False, 15, 17),
])
def test_conv_tc_matches_plain_version(card, chans, cout, stride, res, h, w):
    g = torch.Generator(device=card).manual_seed(sum(chans) + cout + h)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    parts = [r(2, c, h, w).to(BF16) for c in chans]
    if len(parts) == 2:  # the second part as a channel slice of a wider tensor
        parts[1] = r(2, chans[1] + 5, h, w).to(BF16)[:, 2:2 + chans[1]]
    cin = sum(chans)
    wt = r(cout, cin, 3, 3) * (9 * cin) ** -0.5  # f32, not bf16-valued: the kernel rounds it
    b = r(cout)
    sc = r(cout, cin, 1, 1) * cin ** -0.5 if res else None
    kernels.reset_launch_counts()
    got = ops.conv3x3(parts, wt, b, stride=stride, relu=True, shortcut=sc)
    want = ops.conv3x3_plain(parts, wt, b, stride=stride, relu=True, shortcut=sc)
    assert got.dtype == BF16 and got.shape == want.shape
    assert _close(got, want)
    assert kernels.launch_counts()["conv_tc"] == 1 and kernels.launch_counts()["conv"] == 0
    # bf16 weights and bias read as stored
    got16 = ops.conv3x3(parts, wt.to(BF16), b.to(BF16), stride=stride, relu=True,
                        shortcut=None if sc is None else sc.to(BF16))
    assert _close(got16, ops.conv3x3_plain(parts, wt.to(BF16), b.to(BF16), stride=stride, relu=True,
                                           shortcut=None if sc is None else sc.to(BF16)))


@pytest.mark.cuda
@pytest.mark.parametrize("chans,cout,h,w", [
    ((1, 64), 64, 11, 38), ((1, 32), 32, 9, 19), ((16,), 16, 6, 10), ((33,), 32, 7, 21), ((3, 5), 8, 5, 13),
    ((64,), 64, 13, 9),
])
def test_conv_transpose_tc_matches_plain_version(card, chans, cout, h, w):
    g = torch.Generator(device=card).manual_seed(sum(chans) + h)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    parts = [r(2, c, h, w).to(BF16) for c in chans]
    cin = sum(chans)
    wt, b = r(cin, cout, 4, 4) * (4 * cin) ** -0.5, r(cout)
    kernels.reset_launch_counts()
    got = ops.conv_transpose4x4s2(parts, wt, b)
    assert got.shape == (2, cout, 2 * h, 2 * w) and got.dtype == BF16
    assert _close(got, ops.conv_transpose4x4s2_plain(parts, wt, b))
    assert kernels.launch_counts()["conv_transpose_tc"] == 1 and kernels.launch_counts()["conv_transpose"] == 0
    # each output parity (py, px) runs its own 2x2 taps and B block: held apart
    want = ops.conv_transpose4x4s2_plain(parts, wt, b)
    for py in (0, 1):
        for px in (0, 1):
            assert _close(got[..., py::2, px::2], want[..., py::2, px::2]), (py, px)


def _stored_as(t, layout):
    """``t`` (NCHW) held as ``layout`` names: "nchw" contiguous, "slice" a
    channel slice of a wider tensor, "nhwc" channels-last storage read as
    NCHW, "wstride" every other column of a tensor twice as wide; the last
    two have no 16-byte rows (the kernel's element-wise staging)."""
    if layout == "slice":
        wide = torch.zeros(t.shape[0], t.shape[1] + 5, *t.shape[2:], device=t.device, dtype=t.dtype)
        wide[:, 2:2 + t.shape[1]] = t
        return wide[:, 2:2 + t.shape[1]]
    if layout == "nhwc":
        return t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    if layout == "wstride":
        wide = torch.zeros(*t.shape[:3], 2 * t.shape[3], device=t.device, dtype=t.dtype)
        wide[..., ::2] = t
        return wide[..., ::2]
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("chans,layouts,cout,stride,res,h,w", [
    ((3,), ("nchw",), 8, 1, False, 21, 37), ((16,), ("nchw",), 16, 2, True, 23, 35),
    ((72,), ("nchw",), 32, 1, True, 19, 70), ((72,), ("nchw",), 64, 2, False, 17, 41),
    ((40, 24, 8), ("nchw", "slice", "nhwc"), 64, 1, True, 13, 29), ((16, 3), ("wstride", "nchw"), 32, 2, False, 15, 27),
    ((32,), ("nchw",), 64, 1, False, 9, 100), ((32, 32), ("nchw", "nhwc"), 128, 1, False, 11, 19),
    ((8,), ("nhwc",), 16, 1, True, 5, 7), ((64,), ("nchw",), 64, 2, True, 25, 33),
    ((128,), ("nchw",), 64, 1, False, 10, 30), ((3,), ("nchw",), 64, 2, True, 31, 45),
    ((32,), ("slice",), 32, 1, False, 3, 200), ((16,), ("nchw",), 8, 2, True, 1, 1),
])
def test_conv_tc_edges_match_plain_version(card, chans, layouts, cout, stride, res, h, w):
    """Ragged last tiles (W not a multiple of 16), odd H and W at stride 2,
    cin 3 / 16 / 72 / 128, parts of different widths, strided views (no
    16-byte rows), cout 8-128 with and without the residual shortcut."""
    g = torch.Generator(device=card).manual_seed(7 * sum(chans) + cout + h + w)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    parts = [_stored_as(r(2, c, h, w).to(BF16), lay) for c, lay in zip(chans, layouts)]
    cin = sum(chans)
    wt, b = r(cout, cin, 3, 3) * (9 * cin) ** -0.5, r(cout)
    sc = r(cout, cin, 1, 1) * cin ** -0.5 if res else None
    kernels.reset_launch_counts()
    got = ops.conv3x3(parts, wt, b, stride=stride, relu=True, shortcut=sc)
    want = ops.conv3x3_plain(parts, wt, b, stride=stride, relu=True, shortcut=sc)
    assert got.shape == want.shape and _close(got, want)
    assert kernels.launch_counts()["conv_tc"] == 1


@pytest.mark.cuda
def test_tc_forms_refuse_what_they_cannot_take(card):
    x = torch.randn(1, 8, 6, 10, device=card).to(BF16)
    with pytest.raises(RuntimeError, match="conv_tc"):  # a residual form wider than 64
        ops.conv3x3([x], torch.randn(96, 8, 3, 3, device=card), relu=True,
                    shortcut=torch.randn(96, 8, 1, 1, device=card))
    with pytest.raises(RuntimeError, match="conv_transpose_tc"):  # a transpose conv wider than 64
        ops.conv_transpose4x4s2([x], torch.randn(8, 96, 4, 4, device=card))
    with pytest.raises(ValueError):  # bf16 -> bf16 wider than 8 is not the CUDA-core form's
        convops._conv3x3_kernel([x], torch.randn(16, 8, 3, 3, device=card), None, 1, True, None, BF16)


@pytest.mark.cuda
def test_residual_function_backward_on_the_kernels(card):
    g = torch.Generator(device=card).manual_seed(11)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    for dtype in (torch.float32, BF16):
        x = leaf(r(2, 16, 14, 22).to(dtype))
        w, b, sc = leaf(r(32, 16, 3, 3).to(dtype) * 0.2), leaf(r(32).to(dtype)), leaf(r(32, 16, 1, 1).to(dtype) * 0.2)
        kernels.reset_launch_counts()
        out = ops.conv3x3_residual_trainable([x], w, b, sc)
        out.float().square().sum().backward()
        counts = kernels.launch_counts()
        form, d_x, wgrad = (("conv_tc", "conv_input_grad_tc", "wgrad_tc") if dtype == BF16
                            else ("conv", "conv_kxk", "wgrad"))
        assert (counts[form], counts[d_x], counts[wgrad]) == (2, 1, 1)
        cpu = [leaf(t.detach().cpu()) for t in (x, w, b, sc)]
        ref = ops.conv3x3_residual_trainable([cpu[0]], *cpu[1:3], cpu[3])
        ref.float().square().sum().backward()
        bar = 1e-4 if dtype == torch.float32 else 2e-2
        for t, c in zip((x, w, b, sc), cpu):
            assert _close(t.grad.float().cpu(), c.grad.float(), bar)
