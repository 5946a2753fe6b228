"""The thin CUDA-core form of K2 (``csrc/conv_thin.cu``: the u8 frame's
residual encoder and the cout < 8 heads, bf16 out), K4 on the tensor cores
(``csrc/conv_chain_tc.cu``, bf16), and the wrappers' device guard.

On the CPU:
  * the bf16 chain's plain version against the JAX package's Pallas chain
    (``conv2_chain_pallas_aligned``, interpret mode) on the same bf16
    operands, within 4e-3 rel RMSE (about one bf16 ulp: the two round the
    intermediate and the output once each, but sum in other orders), and
    no further from a float64 run than JAX is (x1.25);
  * the thin forms' plain versions against the JAX package's Pallas conv on
    the same u8 / bf16 operands and bf16-valued kernel: the u8 residual
    encoder within 4e-3, a cout-1 head within 4e-3;
  * the routing of the thin and chain forms, and that the thin kernel reads
    exactly the weight values its plain version reads;
  * every kernel wrapper launches inside the device guard of its output's
    device (a stub library records it), and the guard makes that device
    current;
  * ``make_guided_predict`` leaves a model in train mode as it found it.

On the card (``cuda``-marked, skipped here): each new form against its plain
version at ragged shapes within 5e-3 rel RMSE (bf16 output rounding), and
the calls it refuses raise. JAX is imported only by the tests that use it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_thin_chain.py
"""
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nconv_tpu_torch import kernels, ops
from nconv_tpu_torch.ops import convops, nconv

BF16 = torch.bfloat16
BF16_BAR = 5e-3
ULP_BAR = 4e-3  # about one bf16 ulp of rel RMSE


def _jax():
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    return jax, jnp, pltpu


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def bhcw_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a, np.float32), (0, 2, 1, 3))))


def nchw_to_bhcw(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 1, 3))


def hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))))


# ---------------------------------------------------------------------------
# Plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,f1,f2", [((1, 10, 16, 21), 16, 8), ((2, 7, 8, 13), 8, 16)])
def test_bf16_chain_plain_matches_pallas_chain(shape, f1, f2):
    """``conv3x3_chain2_plain`` on bf16 against ``conv2_chain_pallas_aligned``
    in interpret mode, run as tests/test_aligned_kernels.py runs it (lanes
    padded to 128), on the same bf16 input, kernels and biases."""
    jax, jnp, pltpu = _jax()
    from nconv_tpu.ops.pallas_chain import conv2_chain_pallas_aligned

    rng = np.random.default_rng(sum(shape) + f1)
    b, h, c, w = shape
    x = _bf16(rng.standard_normal(shape))
    k1, k2 = _bf16(rng.standard_normal((3, 3, c, f1)) * 0.3), _bf16(rng.standard_normal((3, 3, f1, f2)) * 0.3)
    b1, b2 = _bf16(rng.standard_normal(f1) * 0.1), _bf16(rng.standard_normal(f2) * 0.1)
    wp = (w + 127) // 128 * 128
    xp = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, 0), (0, 0), (0, 0), (0, wp - w)))
    with pltpu.force_tpu_interpret_mode():
        out, ho, wo = conv2_chain_pallas_aligned(
            xp, *(jnp.asarray(a, jnp.bfloat16) for a in (k1, b1, k2, b2)), w=w, tile_h=8)
    assert out.dtype == jnp.bfloat16 and (ho, wo) == (h, w)
    want = np.asarray(out[:, :ho, :, :wo].astype(jnp.float32))
    tx = bhcw_to_nchw(x).to(BF16)
    port = ops.conv3x3_chain2_plain(tx, hwio_to_oihw(k1), torch.from_numpy(b1), hwio_to_oihw(k2),
                                    torch.from_numpy(b2))
    assert port.dtype == BF16
    assert rel(nchw_to_bhcw(port), want) <= ULP_BAR
    # both against the same chain in float64 on the same (bf16-valued) operands
    ref = ops.conv3x3_chain2_plain(tx.double(), hwio_to_oihw(k1).double(), torch.from_numpy(b1).double(),
                                   hwio_to_oihw(k2).double(), torch.from_numpy(b2).double())
    ref = nchw_to_bhcw(ref)
    assert rel(nchw_to_bhcw(port), ref) <= 1.25 * rel(want, ref) + 1e-6


def test_u8_residual_plain_matches_pallas_conv():
    """The encoder's form: ``relu(conv3x3(u8) + b) + conv1x1(u8)`` to bf16
    against JAX's stacked residual conv on the same u8 frame (decoded as raw
    values) and bf16 kernel, which types the output by the kernel."""
    jax, jnp, pltpu = _jax()
    from nconv_tpu.ops.pallas_conv import conv2d_pallas_bhcw

    rng = np.random.default_rng(3)
    b, h, w, n = 2, 9, 21, 16
    frame = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    km = _bf16(rng.standard_normal((3, 3, 3, n)) * 0.01)
    ks = _bf16(rng.standard_normal((3, n)) * 0.01)
    bias = _bf16(rng.standard_normal(n))
    stacked = np.concatenate([km, np.zeros((3, 3, 3, n), np.float32)], -1)
    stacked[1, 1, :, n:] = ks
    x_bhcw = jnp.transpose(jnp.asarray(frame), (0, 1, 3, 2))
    with pltpu.force_tpu_interpret_mode():
        out = conv2d_pallas_bhcw(x_bhcw, jnp.asarray(stacked, jnp.bfloat16),
                                 jnp.asarray(bias, jnp.bfloat16), padding=1, residual_channels=n)
    assert out.dtype == jnp.bfloat16
    want = np.asarray(out.astype(jnp.float32))
    x = torch.from_numpy(frame).permute(0, 3, 1, 2)  # read through its NHWC strides
    port = ops.conv3x3_plain([x], hwio_to_oihw(km), torch.from_numpy(bias), relu=True,
                             shortcut=torch.from_numpy(np.ascontiguousarray(ks.T)).reshape(n, 3, 1, 1),
                             out_dtype=BF16)
    assert port.dtype == BF16
    assert rel(nchw_to_bhcw(port), want) <= ULP_BAR


@pytest.mark.parametrize("cin", [32, 64])
def test_head_plain_matches_pallas_conv(cin):
    """A depth head: bf16 parts -> 1 channel, no bias, bf16 out."""
    jax, jnp, pltpu = _jax()
    from nconv_tpu.ops.pallas_conv import conv2d_pallas_bhcw

    rng = np.random.default_rng(cin)
    x = _bf16(rng.standard_normal((2, 6, cin, 19)))
    k = _bf16(rng.standard_normal((3, 3, cin, 1)) * (9 * cin) ** -0.5)
    with pltpu.force_tpu_interpret_mode():
        out = conv2d_pallas_bhcw(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), padding=1)
    want = np.asarray(out.astype(jnp.float32))
    port = ops.conv3x3([bhcw_to_nchw(x).to(BF16)], hwio_to_oihw(k))
    assert port.dtype == BF16 and port.shape == (2, 1, 6, 19)
    assert rel(nchw_to_bhcw(port), want) <= ULP_BAR


# ---------------------------------------------------------------------------
# Routing and the weight contract
# ---------------------------------------------------------------------------

def test_thin_routing_rule():
    u8 = torch.uint8
    assert ops.on_thin(u8, BF16, 32, 1) and ops.on_thin(BF16, BF16, 1, 1) and ops.on_thin(BF16, BF16, 7, 1)
    assert not ops.on_thin(BF16, BF16, 8, 1)  # the tensor cores' (conv_tc)
    assert not ops.on_thin(u8, torch.float32, 32, 1)  # f32 serving keeps conv
    assert not ops.on_thin(torch.float32, torch.float32, 1, 1)
    assert not ops.on_thin(u8, BF16, 32, 2) and not ops.on_thin(BF16, BF16, 1, 2)  # stride 2 keeps conv


@contextlib.contextmanager
def captured_launches():
    """``kernels.launch`` replaced by a recorder of (counter, entry, args)."""
    seen = []
    with mock.patch.object(kernels, "launch", lambda counter, entry, on, *args: seen.append((counter, entry, args))):
        yield seen


@pytest.mark.parametrize("dtype", [torch.uint8, BF16])
def test_thin_kernel_reads_the_weights_its_plain_version_reads(dtype):
    """The thin kernel is handed the weights as stored with the parts' and
    the weights' type codes, and reads them rounded to bf16 (nearest even)
    over bf16 parts and as stored over uint8 parts (the served model's
    weights are bf16-valued already), the bias as stored
    (``csrc/conv_thin.cu``, ``weight``): the values the plain version
    convolves with. The card test ``test_conv_thin_rounds_weights_as_its_plain_version``
    holds the kernel to that reading."""
    g = torch.Generator().manual_seed(5)
    cout = 16 if dtype == torch.uint8 else 1
    w = torch.randn(cout, 3, 3, 3, generator=g) * 0.1  # not bf16-valued
    sc = torch.randn(cout, 3, 1, 1, generator=g) * 0.1 if dtype == torch.uint8 else None
    b = torch.randn(cout, generator=g)
    if dtype == torch.uint8:
        x = torch.randint(0, 256, (1, 5, 7, 3), generator=g, dtype=torch.uint8).permute(0, 3, 1, 2)
    else:
        x = torch.randn(1, 3, 5, 7, generator=g).to(BF16)
    with captured_launches() as seen:
        convops._conv_thin_kernel([x], w, b, True, sc)
    (counter, entry, args), = seen
    assert (counter, entry) == ("conv_thin", "nct_conv_thin")
    in_code, w_k, s_k, b_k, w_code = args[3], *args[-6:-2]
    assert in_code == kernels.DTYPE_CODE[dtype] and w_code == kernels.DTYPE_CODE[torch.float32]
    assert torch.equal(w_k, w) and torch.equal(b_k, b) and (s_k is None) == (sc is None)
    # the kernel's reading of them, and the plain version's output from those values
    read = (lambda t: t) if in_code == kernels.DTYPE_CODE[torch.uint8] else (lambda t: t.to(BF16).float())
    xf = x.float()
    want = torch.relu(F.conv2d(xf, read(w_k), b_k, padding=1)) + (F.conv2d(xf, read(s_k)) if sc is not None else 0)
    assert torch.equal(ops.conv3x3_plain([x], w, b, relu=True, shortcut=sc, out_dtype=BF16), want.to(BF16))


def test_chain_routing_and_weight_reading():
    """bf16 chains go to the tensor-core form with their weights as stored
    (the kernel rounds them to bf16 as it stages them, as the plain version
    does), f32 chains to K4's CUDA-core form; each form refuses the other's
    dtype."""
    g = torch.Generator().manual_seed(6)
    w1, w2 = torch.randn(32, 16, 3, 3, generator=g), torch.randn(32, 32, 3, 3, generator=g)
    b1, b2 = torch.randn(32, generator=g), torch.randn(32, generator=g)
    for dtype, counter in ((BF16, "conv_chain_tc"), (torch.float32, "conv_chain")):
        x = torch.randn(1, 16, 6, 9, generator=g).to(dtype)
        with captured_launches() as seen, mock.patch.object(kernels, "on_card", lambda *t: True):
            ops.conv3x3_chain2(x, w1, b1, w2, b2)
        (got, _, args), = seen
        assert got == counter
        if dtype == BF16:
            assert all(a is t or torch.equal(a, t) for a, t in zip(args[7:11], (w1, b1, w2, b2)))
    with pytest.raises(ValueError):
        convops._chain_kernel(torch.zeros(1, 16, 6, 9, dtype=BF16), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        convops._chain_tc_kernel(torch.zeros(1, 16, 6, 9), w1, b1, w2, b2)
    with pytest.raises(ValueError):  # cmid 96 is wider than the tensor-core form
        convops._chain_tc_kernel(torch.zeros(1, 16, 6, 9, dtype=BF16), w1.repeat(3, 1, 1, 1), b1.repeat(3),
                                 w2.repeat(1, 3, 1, 1), b2)
    with pytest.raises(TypeError):  # weights and biases in one dtype
        convops._chain_tc_kernel(torch.zeros(1, 16, 6, 9, dtype=BF16), w1, b1.to(BF16), w2, b2)
    # bf16: the plain version reads the weights rounded to bf16, the biases as held
    x = torch.randn(1, 16, 6, 9, generator=g).to(BF16)
    assert torch.equal(ops.conv3x3_chain2_plain(x, w1, b1, w2, b2),
                       ops.conv3x3_chain2_plain(x, w1.to(BF16).float(), b1, w2.to(BF16).float(), b2))


def test_thin_form_refuses_what_it_cannot_take():
    x8 = torch.zeros(1, 5, 6, 7, dtype=torch.uint8)
    with pytest.raises(ValueError):  # more than 4 uint8 channels
        convops._conv_thin_kernel([x8], torch.zeros(8, 5, 3, 3), None, True, None)
    xb = torch.zeros(1, 8, 6, 7, dtype=BF16)
    with pytest.raises(ValueError):  # no bf16 residual form
        convops._conv_thin_kernel([xb], torch.zeros(1, 8, 3, 3), None, True, torch.zeros(1, 8, 1, 1))
    with pytest.raises(ValueError):  # 8 output channels belong to the tensor cores
        convops._conv_thin_kernel([xb], torch.zeros(8, 8, 3, 3), None, False, None)
    with pytest.raises(ValueError):  # and the CUDA-core form refuses the thin form's calls
        convops._conv3x3_kernel([xb], torch.zeros(1, 8, 3, 3), None, 1, False, None, BF16)


# ---------------------------------------------------------------------------
# The device guard (every wrapper) and make_guided_predict's mode
# ---------------------------------------------------------------------------

_SIZES = ("nct_filtergrad_slices", "nct_wgrad_slices", "nct_wgrad_tc_slices")  # plan queries, not launches


class _StubLib:
    """Every entry returns 0 and notes the device the guard made current."""

    def __init__(self, current):
        self.current, self.calls = current, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, self.current[0]))
            return 1 if name in _SIZES else 0
        return entry


def _every_wrapper(r):
    """One call of every kernel wrapper of ops/ on CPU tensors: (counter, call)."""
    bf, u8 = BF16, torch.uint8
    x, xb = r(1, 8, 6, 10), r(1, 8, 6, 10).to(bf)
    x8 = torch.zeros(1, 3, 6, 10, dtype=u8)
    w8, b8 = r(8, 8, 3, 3), r(8)
    return [
        ("nconv", lambda: nconv._nconv2d_kernel([x.abs()], [torch.ones_like(x)], r(8, 8, 3, 3).abs(), b8, 1,
                                                [False], 0, False, 1e-20)),
        ("conv", lambda: convops._conv3x3_kernel([x], w8, b8, 1, True, None, torch.float32)),
        ("conv_tc", lambda: convops._conv_tc_kernel([xb], w8, b8, 1, True, None)),
        ("conv_thin", lambda: convops._conv_thin_kernel([x8], r(32, 3, 3, 3), r(32), True, r(32, 3, 1, 1))),
        ("conv_thin", lambda: convops._conv_thin_kernel([xb], r(1, 8, 3, 3), None, False, None)),
        ("conv_transpose", lambda: convops._conv_transpose_kernel([x], r(8, 8, 4, 4), b8, True)),
        ("conv_transpose_tc", lambda: convops._conv_transpose_tc_kernel([xb], r(8, 8, 4, 4), b8, True)),
        ("conv_chain", lambda: convops._chain_kernel(x, w8, b8, w8, b8)),
        ("conv_chain_tc", lambda: convops._chain_tc_kernel(xb, r(32, 8, 3, 3), r(32), r(32, 32, 3, 3), r(32))),
        ("conv_kxk", lambda: convops._conv_kxk_kernel(x, w8, 1, 1)),
        ("conv_input_grad_tc", lambda: convops._conv_input_grad_tc_kernel(xb, w8.to(bf), 1)),
        ("conv4x4s2", lambda: convops._conv_kxk_kernel(x, r(8, 8, 4, 4), 1, 2)),
        ("conv4x4s2_tc", lambda: convops._conv4x4s2_tc_kernel(xb, r(8, 8, 4, 4).to(bf))),
        ("filtergrad", lambda: convops._filtergrad_kernel(x, x, 3, 1, 1)),
        ("conv_transpose3x3s2", lambda: convops._conv_transpose3x3s2_kernel(x, w8)),
        ("conv_transpose3x3s2_tc", lambda: convops._conv_transpose3x3s2_tc_kernel(xb, w8.to(bf))),
        ("wgrad", lambda: convops._wgrad_kernel([x], [x], 3, 1, 1)),
        ("wgrad_tc", lambda: convops._wgrad_tc_kernel([xb], [xb], 3, 1, 1)),
    ]


def test_every_wrapper_launches_inside_its_device_guard():
    """With the library stubbed and the CPU tensors taken as on the card,
    each wrapper's launch happens inside ``kernels.device_guard`` of its
    output's device, and counts once."""
    current = [None]

    @contextlib.contextmanager
    def guard(t):
        prev, current[0] = current[0], t.device
        try:
            yield
        finally:
            current[0] = prev

    stub = _StubLib(current)
    g = torch.Generator().manual_seed(8)
    r = lambda *s: torch.randn(*s, generator=g)
    with mock.patch.object(kernels, "lib", lambda: stub), mock.patch.object(kernels, "device_guard", guard), \
            mock.patch.object(kernels, "stream_of", lambda t: 0):
        for counter, call in _every_wrapper(r):
            kernels.reset_launch_counts()
            stub.calls.clear()
            out = call()
            launched = [(n, d) for n, d in stub.calls if n not in _SIZES]
            assert len(launched) == 1 and launched[0][1] == torch.device("cpu"), (counter, stub.calls)
            assert current[0] is None  # the guard was left
            assert kernels.launch_counts() == {k: int(k == counter) for k in kernels.LAUNCHES}, counter
            assert (out[0] if isinstance(out, tuple) else out).device.type == "cpu"
    assert {c for c, _ in _every_wrapper(r)} == set(kernels.LAUNCHES)  # every kernel is covered


def test_device_guard_makes_the_tensor_device_current():
    """``kernels.device_guard`` switches to the tensor's device index for
    the enclosed launch and back after it (torch's device switch recorded)."""
    switched = []

    def exchange(idx):
        switched.append(idx)
        return 0 if len(switched) == 1 else idx

    class OnCard:
        device = torch.device("cuda", 1)

    with mock.patch.object(torch.cuda, "_exchange_device", exchange), \
            mock.patch.object(torch.cuda, "_maybe_exchange_device", exchange):
        with kernels.device_guard(OnCard()):
            assert switched == [1]
    assert switched == [1, 0]


def test_guided_predict_restores_the_callers_mode():
    """A model in train mode stays in train mode across ``predict``, which
    runs in eval mode (BN on its running statistics); its output is the
    eval-mode forward's."""
    from nconv_tpu_torch.models import GuidedDepthNet
    from nconv_tpu_torch.training import make_guided_predict

    model = GuidedDepthNet(device="cpu", seed=2)
    with torch.no_grad():
        for m in model.modules():  # running statistics that differ from a batch's
            if hasattr(m, "running_var"):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    rng = np.random.default_rng(4)
    batch = {"rgb": rng.random((1, 16, 24, 3), np.float32) * 255,
             "depth": (rng.random((1, 16, 24, 1)) * 10 * (rng.random((1, 16, 24, 1)) < 0.3)).astype(np.float32)}
    model.train()
    got = make_guided_predict(model)(batch)
    assert model.training
    model.eval()
    with torch.no_grad():
        want = model(torch.from_numpy(batch["rgb"]), torch.from_numpy(batch["depth"]))[0][-1]
    assert torch.equal(got, want)
    assert not make_guided_predict(model)(batch).requires_grad and not model.training


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
@pytest.mark.parametrize("chans,cout,bias,h,w", [
    ((64,), 1, False, 23, 152), ((32,), 1, False, 37, 300), ((5, 3), 1, True, 9, 21), ((16,), 3, True, 13, 264),
    ((64,), 1, False, 44, 152),
])
def test_conv_thin_head_matches_plain_version(card, chans, cout, bias, h, w):
    g = torch.Generator(device=card).manual_seed(sum(chans) + h)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    parts = [r(2, c, h, w).to(BF16) for c in chans]
    if len(parts) == 2:  # the second part as a channel slice of a wider tensor
        parts[1] = r(2, chans[1] + 5, h, w).to(BF16)[:, 2:2 + chans[1]]
    cin = sum(chans)
    wt, b = r(cout, cin, 3, 3) * (9 * cin) ** -0.5, r(cout) if bias else None
    kernels.reset_launch_counts()
    got = ops.conv3x3(parts, wt, b, relu=bias)
    want = ops.conv3x3_plain(parts, wt, b, relu=bias)
    assert got.dtype == BF16 and got.shape == want.shape and _close(got, want)
    assert kernels.launch_counts()["conv_thin"] == 1 and kernels.launch_counts()["conv"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, BF16])
def test_conv_thin_rounds_weights_as_its_plain_version(card, dtype):
    """Over bf16 parts the kernel reads an f32 weight rounded to bf16 (the
    same output, bit for bit, as from the pre-rounded weight); over uint8
    parts as stored (another output), as the plain version reads it."""
    g = torch.Generator(device=card).manual_seed(12)
    cout = 32 if dtype == torch.uint8 else 1
    if dtype == torch.uint8:
        x = torch.randint(0, 256, (2, 40, 64, 3), generator=g, device=card, dtype=torch.uint8).permute(0, 3, 1, 2)
    else:
        x = torch.randn(2, 3, 40, 64, generator=g, device=card).to(BF16)
    w = torch.randn(cout, 3, 3, 3, generator=g, device=card) * 0.05  # not bf16-valued
    got, got_rounded = (ops.conv3x3([x], t, out_dtype=BF16) for t in (w, w.to(BF16).float()))
    assert torch.equal(got, got_rounded) == (dtype == BF16)
    assert _close(got, ops.conv3x3_plain([x], w, out_dtype=BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cout,res", [(2, 352, 1216, 32, True), (1, 19, 37, 32, True), (2, 8, 40, 5, False)])
def test_conv_thin_u8_matches_plain_version(card, b, h, w, cout, res):
    g = torch.Generator(device=card).manual_seed(h + w)
    frame = torch.randint(0, 256, (b, h, w, 3), generator=g, device=card, dtype=torch.uint8)
    x = frame.permute(0, 3, 1, 2)  # read through its NHWC strides
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    wt, bias = (r(cout, 3, 3, 3) * 0.01).to(BF16).float(), r(cout).to(BF16).float()
    sc = (r(cout, 3, 1, 1) * 0.01).to(BF16).float() if res else None
    kernels.reset_launch_counts()
    got = ops.conv3x3([x], wt, bias, relu=True, shortcut=sc, out_dtype=BF16)
    want = ops.conv3x3_plain([x], wt, bias, relu=True, shortcut=sc, out_dtype=BF16)
    assert got.dtype == BF16 and _close(got, want)
    assert kernels.launch_counts()["conv_thin"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cmid,cout,h,w", [
    (2, 64, 64, 64, 44, 152), (1, 64, 32, 32, 19, 37), (2, 32, 32, 32, 17, 45), (1, 3, 32, 64, 9, 13),
    (1, 80, 64, 32, 11, 24), (2, 32, 32, 16, 20, 36), (1, 24, 48, 40, 10, 30),
])
def test_conv_chain_tc_matches_plain_version(card, b, cin, cmid, cout, h, w):
    g = torch.Generator(device=card).manual_seed(cin + cmid + h)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=card) * scale
    x = r(b, cin, h, w).to(BF16)
    w1, w2 = r(cmid, cin, 3, 3, scale=(9 * cin) ** -0.5), r(cout, cmid, 3, 3, scale=(9 * cmid) ** -0.5)
    b1, b2 = r(cmid, scale=0.1), r(cout, scale=0.1)
    for dt in (torch.float32, BF16):
        ws = [t.to(dt) for t in (w1, b1, w2, b2)]
        kernels.reset_launch_counts()
        got = ops.conv3x3_chain2(x, *ws)
        assert got.dtype == BF16 and _close(got, ops.conv3x3_chain2_plain(x, *ws))
        assert kernels.launch_counts()["conv_chain_tc"] == 1 and kernels.launch_counts()["conv_chain"] == 0


@pytest.mark.cuda
def test_thin_and_chain_tc_refuse_what_they_cannot_take(card):
    x = torch.randn(1, 96, 6, 10, device=card).to(BF16)
    with pytest.raises(RuntimeError, match="conv_chain_tc"):  # weights and tiles over 227 KB
        ops.conv3x3_chain2(x, torch.randn(64, 96, 3, 3, device=card), torch.zeros(64, device=card),
                           torch.randn(64, 64, 3, 3, device=card), torch.zeros(64, device=card))
    with pytest.raises(ValueError):  # wider than 64
        ops.conv3x3_chain2(x[:, :8], torch.randn(80, 8, 3, 3, device=card), torch.zeros(80, device=card),
                           torch.randn(32, 80, 3, 3, device=card), torch.zeros(32, device=card))
    with pytest.raises(ValueError):  # more than 4 uint8 channels
        ops.conv3x3([torch.zeros(1, 5, 6, 7, dtype=torch.uint8, device=card)], torch.randn(8, 5, 3, 3, device=card),
                    out_dtype=BF16)
