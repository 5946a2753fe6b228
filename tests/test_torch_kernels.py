"""The port's kernel wrappers, without JAX.

The ``cuda`` tests hold each hand-written kernel against its plain PyTorch
version on the card (bars: rel RMSE 1e-5 in f32, 5e-3 in bf16, the output
rounding); they skip without a GPU. On the card, run this file alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest imports jax, which the card's
machine need not have.) The other tests check the wrappers' dispatch and
input checks on the CPU.
"""
import pytest
import torch

from nconv_tpu_torch import kernels, ops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _close(a, b, bar):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm()) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_match_plain_versions(card, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=card).to(dtype)
    bar = 1e-5 if dtype == torch.float32 else 5e-3
    parts = [r(2, 5, 20, 36), r(2, 3, 20, 36)]
    w, b, sc = r(32, 8, 3, 3), r(32), r(32, 8, 1, 1)
    for stride in (1, 2):
        for shortcut in (None, sc):
            assert _close(ops.conv3x3(parts, w, b, stride=stride, relu=True, shortcut=shortcut),
                          ops.conv3x3_plain(parts, w, b, stride=stride, relu=True, shortcut=shortcut), bar)
    head = r(1, 8, 3, 3)
    assert _close(ops.conv3x3(parts, head), ops.conv3x3_plain(parts, head), bar)
    wt = r(8, 16, 4, 4)
    assert _close(ops.conv_transpose4x4s2(parts, wt, b[:16]),
                  ops.conv_transpose4x4s2_plain(parts, wt, b[:16]), bar)
    x = r(2, 32, 20, 36)
    w1, w2 = r(32, 32, 3, 3) * 0.1, r(16, 32, 3, 3) * 0.1
    assert _close(ops.conv3x3_chain2(x, w1, b, w2, b[:16]),
                  ops.conv3x3_chain2_plain(x, w1, b, w2, b[:16]), bar)


@pytest.mark.cuda
def test_conv_kernel_decodes_a_u8_nhwc_frame(card):
    g = torch.Generator(device=card).manual_seed(1)
    frame = torch.randint(0, 256, (2, 20, 36, 3), generator=g, device=card, dtype=torch.uint8)
    x = frame.permute(0, 3, 1, 2)  # read through its strides
    w, sc = torch.randn(32, 3, 3, 3, generator=g, device=card), torch.randn(32, 3, 1, 1, generator=g, device=card)
    b = torch.randn(32, generator=g, device=card)
    got = ops.conv3x3([x], w, b, relu=True, shortcut=sc)
    assert got.dtype == torch.float32
    assert _close(got, ops.conv3x3_plain([x], w, b, relu=True, shortcut=sc), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k,pad,crop,pool,up2", [
    (5, 2, 0, True, None), (3, 1, 0, False, [False, True]),
    (3, 0, 0, False, [True, False]), (1, 2, 1, False, None),
])
def test_nconv_kernel_matches_plain_version(card, k, pad, crop, pool, up2):
    g = torch.Generator(device=card).manual_seed(2)
    rnd = lambda *s: torch.rand(*s, generator=g, device=card)
    if up2 is None:
        shapes = [(2, 8, 20, 36)]
    else:
        shapes = [(2, 8, 10, 18) if u else (2, 8, 20, 36) for u in up2]
    d = [rnd(*s) * 10 for s in shapes]
    c = [(rnd(*s) > 0.5).float() for s in shapes]
    cout = 1 if k == 1 else 8
    w = rnd(cout, 8 * len(shapes), k, k)
    b = torch.randn(cout, generator=g, device=card)
    got = ops.nconv2d_fused(d, c, w, b, padding=pad, up2=up2, crop=crop, pool_out=pool)
    want = ops.nconv2d_fused_plain(d, c, w, b, padding=pad, up2=up2 or [False], crop=crop, pool_out=pool)
    assert len(got) == len(want)
    assert all(_close(a, e, 1e-5) for a, e in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cmid,cout,h,w", [
    (64, 64, 64, 22, 76), (64, 64, 64, 44, 152), (64, 32, 32, 88, 304), (32, 32, 32, 176, 608), (16, 32, 16, 9, 31),
])
def test_chain_kernel_matches_plain_version(card, cin, cmid, cout, h, w):
    """K4's f32 form at the fusion stages' widths: tile T at 44x152 and
    below (S's grid under 132 blocks at B = 2), S from 88x304 up; ragged
    edges."""
    g = torch.Generator(device=card).manual_seed(4)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=card) * scale
    x = r(2, cin, h, w)
    w1, w2 = r(cmid, cin, 3, 3, scale=(9 * cin) ** -0.5), r(cout, cmid, 3, 3, scale=(9 * cmid) ** -0.5)
    b1, b2 = r(cmid, scale=0.1), r(cout, scale=0.1)
    kernels.reset_launch_counts()
    got = ops.conv3x3_chain2(x, w1, b1, w2, b2)
    assert kernels.launch_counts()["conv_chain"] == 1
    assert _close(got, ops.conv3x3_chain2_plain(x, w1, b1, w2, b2), 1e-5)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    kernels.reset_launch_counts()
    x = torch.randn(1, 4, 8, 8)
    ops.conv3x3([x], torch.randn(8, 4, 3, 3), relu=True)
    ops.conv_transpose4x4s2([x], torch.randn(4, 8, 4, 4))
    ops.conv3x3_chain2(x, torch.randn(8, 4, 3, 3), torch.zeros(8), torch.randn(8, 8, 3, 3), torch.zeros(8))
    ops.nconv2d_fused([x.abs()], [torch.ones_like(x)], torch.rand(8, 4, 3, 3), torch.zeros(8), padding=1)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def test_wrappers_reject_mixed_devices():
    with pytest.raises(ValueError):
        kernels.on_card(torch.zeros(1), torch.empty(0, device="meta"))


def test_wrappers_check_their_inputs():
    x = torch.randn(1, 4, 8, 8)
    with pytest.raises(ValueError):  # parts disagree on (B, H, W)
        ops.conv3x3([x, torch.randn(1, 4, 8, 9)], torch.randn(8, 8, 3, 3))
    with pytest.raises(TypeError):  # parts must share a dtype
        ops.conv_transpose4x4s2([x, x.to(torch.bfloat16)], torch.randn(8, 8, 4, 4))
    with pytest.raises(ValueError):  # the residual form has its ReLU
        ops.conv3x3([x], torch.randn(8, 4, 3, 3), shortcut=torch.randn(8, 4, 1, 1))
    with pytest.raises(ValueError):  # an upsampled part must be half the size
        ops.nconv2d_fused([x, x], [x, x], torch.rand(8, 8, 3, 3), torch.zeros(8),
                          padding=1, up2=[False, True])


@pytest.mark.cuda
@pytest.mark.parametrize("k,p,cin,cout", [
    (5, 2, 8, 8), (3, 1, 16, 8), (3, 0, 16, 8), (1, 2, 8, 1), (5, 2, 1, 8),
])
def test_gradient_kernels_match_plain_versions(card, k, p, cin, cout):
    """K2's K x K form (input cotangent) and K5 (weight cotangent) at the
    step-1 layer geometries, over several K5 tiles with ragged edges; K5
    sums in a fixed order, so a repeat is bitwise equal."""
    g = torch.Generator(device=card).manual_seed(3)
    h, w = 37, 150
    ho, wo = h + 2 * p - k + 1, w + 2 * p - k + 1
    cot = torch.randn(3, cout, ho, wo, generator=g, device=card)
    wt = torch.rand(cout, cin, k, k, generator=g, device=card)
    x = torch.randn(3, cin, h, w, generator=g, device=card)
    kernels.reset_launch_counts()
    assert _close(ops.conv2d_input_grad(cot, wt, p), ops.conv2d_input_grad_plain(cot, wt, p), 1e-5)
    dw = ops.conv2d_weight_grad(x, cot, k, p)
    assert _close(dw, ops.conv2d_weight_grad_plain(x, cot, k, p), 1e-5)
    assert torch.equal(dw, ops.conv2d_weight_grad(x, cot, k, p))
    counts = kernels.launch_counts()
    assert (counts["conv_kxk"], counts["filtergrad"]) == (1, 2)


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_require_grad(card):
    """K1 records no graph: with grad enabled it raises instead of returning
    an output without one; the trainable form reaches it inside its
    autograd Function, and its backward runs on K2's K x K form and K5."""
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.rand(2, 8, 16, 24, generator=g, device=card)
    w = torch.rand(8, 8, 3, 3, generator=g, device=card, requires_grad=True)
    b = torch.zeros(8, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        ops.nconv2d_fused([x], [x], w, b, padding=1)
    with torch.no_grad():
        ops.nconv2d_fused([x], [x], w, b, padding=1)
    kernels.reset_launch_counts()
    out, conf = ops.nconv2d_trainable(x, x.requires_grad_(), w, b, padding=1)
    (out.sum() + conf.sum()).backward()
    assert w.grad is not None and x.grad is not None and b.grad is not None
    counts = kernels.launch_counts()
    assert (counts["nconv"], counts["conv_kxk"], counts["filtergrad"]) == (1, 1, 1)


def test_no_graph_guard_raises_only_with_grad_enabled():
    w = torch.zeros(1, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        kernels.no_graph("k", w)
    kernels.no_graph("k", w.detach(), None)
    with torch.no_grad():
        kernels.no_graph("k", w)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(20, 36), (37, 150)])
def test_guided_gradient_kernels_match_plain_versions(card, h, w):
    """K3's 3x3/s2 form, K2's 4x4/s2 form and K6 (3x3 at stride 1 and 2 over
    two parts, 4x4/s2 with the roles swapped) on ragged tiles; K6 sums in a
    fixed order, so a repeat is bitwise equal."""
    g = torch.Generator(device=card).manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    kernels.reset_launch_counts()
    cot2 = r(2, 24, h // 2 + 1, w // 2 + 1)  # the stride-2 cotangent of a (2h', 2w') input
    w3 = r(24, 20, 3, 3)
    assert _close(ops.conv3x3s2_input_grad(cot2, w3), ops.conv3x3s2_input_grad_plain(cot2, w3), 1e-5)
    up = r(2, 16, 2 * h, 2 * w)
    w4 = r(9, 16, 4, 4)
    assert _close(ops.conv_transpose4x4s2_input_grad(up, w4), ops.conv_transpose4x4s2_input_grad_plain(up, w4), 1e-5)
    x = [r(2, 5, h, w), r(2, 70, h, w)[:, 3:]]  # a channel-offset view as the second part
    for stride, m in ((1, 40), (2, 128), (1, 1)):
        gp = [r(2, m, (h - 1) // stride + 1, (w - 1) // stride + 1)]
        dw = ops.conv2d_wgrad(x, gp, 3, stride=stride, padding=1)
        assert _close(dw, ops.conv2d_weight_grad_plain(x, gp, 3, 1, stride=stride), 1e-5)
        assert torch.equal(dw, ops.conv2d_wgrad(x, gp, 3, stride=stride, padding=1))
    small = [r(2, 1, h, w), r(2, 8, h, w)]  # [depth | fusion] of a transpose conv
    dw = ops.conv2d_wgrad([up], small, 4, stride=2, padding=1)
    assert dw.shape == (9, 16, 4, 4)
    assert _close(dw, ops.conv2d_weight_grad_plain([up], small, 4, 1, stride=2), 1e-5)
    counts = kernels.launch_counts()
    assert (counts["conv_transpose3x3s2"], counts["conv4x4s2"], counts["wgrad"]) == (1, 1, 7)


@pytest.mark.cuda
def test_guided_functions_backward_on_the_kernels(card):
    """With grad enabled, the three conv Functions run K2 / K3 forward and
    their backward on K2's K x K forms, K3's 3x3/s2 form and K6."""
    g = torch.Generator(device=card).manual_seed(6)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    x, w1, b = r(2, 8, 16, 24).requires_grad_(), r(16, 8, 3, 3).requires_grad_(), r(16).requires_grad_()
    ws2 = r(32, 16, 3, 3).requires_grad_()
    wt = r(33, 8, 4, 4).requires_grad_()
    kernels.reset_launch_counts()
    y = ops.conv3x3_trainable([x], w1, b, relu=True)
    z = ops.conv3x3_trainable([y], ws2, None, stride=2)
    d = z[:, :1]
    u = ops.conv_transpose4x4s2_trainable([d, z], wt, None, relu=True)
    u.square().sum().backward()
    counts = kernels.launch_counts()
    assert (counts["conv"], counts["conv_transpose"]) == (2, 1)
    assert (counts["conv_kxk"], counts["conv_transpose3x3s2"], counts["conv4x4s2"], counts["wgrad"]) == (1, 1, 1, 3)
    assert all(t.grad is not None for t in (x, w1, b, ws2, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(20, 36), (37, 150)])
def test_bf16_gradient_forms_equal_the_f32_forms_on_widened_inputs(card, h, w):
    """The mixed schedule's backward forms against the f32 forms on the
    widened inputs. Every bf16 form runs on the tensor cores and sums in
    another order than the f32 form, with the tensor cores' truncating f32
    adds: the three input-gradient forms (3x3 stride 1, 4x4/s2, 3x3/s2)
    stand within 5e-3 (the bf16 output rounding); K6 within 1e-5 rel RMSE,
    and no further from a float64 run than the f32 form is, within 2x."""
    g = torch.Generator(device=card).manual_seed(7)
    r = lambda *s: torch.randn(*s, generator=g, device=card).bfloat16()
    wide = lambda ts: [t.float() for t in ts]
    f64 = lambda ts: [t.double() for t in ts]
    kernels.reset_launch_counts()
    w3 = r(24, 20, 3, 3)
    for fn, cot, wt in ((lambda c, k: ops.conv2d_input_grad(c, k, 1), r(2, 24, h, w), w3),
                        (ops.conv_transpose4x4s2_input_grad, r(2, 16, 2 * h, 2 * w), r(9, 16, 4, 4)),
                        (ops.conv3x3s2_input_grad, r(2, 24, h // 2 + 1, w // 2 + 1), w3)):
        got = fn(cot, wt)
        assert got.dtype == torch.bfloat16
        assert _close(got, fn(cot.float(), wt.float()), 5e-3)

    def held(xs, gs, k, stride):
        dw = ops.conv2d_wgrad(xs, gs, k, stride=stride, padding=1)
        assert dw.dtype == torch.float32
        f32 = ops.conv2d_wgrad(wide(xs), wide(gs), k, stride=stride, padding=1)
        exact = ops.conv2d_weight_grad_plain(f64(xs), f64(gs), k, 1, stride=stride)
        assert _close(dw, f32, 1e-5)
        dist = lambda t: float((t.double() - exact).norm() / exact.norm())
        assert dist(dw) <= 2 * dist(f32)

    x = [r(2, 5, h, w), r(2, 70, h, w)[:, 3:]]  # a channel-offset view as the second part
    for stride, m in ((1, 40), (2, 128), (1, 1)):
        held(x, [r(2, m, (h - 1) // stride + 1, (w - 1) // stride + 1)], 3, stride)
    held([r(2, 16, 2 * h, 2 * w)], [r(2, 1, h, w), r(2, 8, h, w)], 4, 2)
    counts = kernels.launch_counts()
    assert (counts["conv_kxk"], counts["conv4x4s2"], counts["conv_transpose3x3s2"], counts["wgrad"]) == (1, 1, 1, 4)
    assert (counts["conv_input_grad_tc"], counts["conv4x4s2_tc"], counts["conv_transpose3x3s2_tc"],
            counts["wgrad_tc"]) == (1, 1, 1, 4)
