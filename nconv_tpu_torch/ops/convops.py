"""Convolutions, NCHW activations with torch weight layouts.

Plain ops: :func:`conv2d` (OIHW) and :func:`conv_transpose2d`
(``nn.ConvTranspose2d`` semantics, weight (cin, cout, kh, kw)).

Fused layer ops, each a kernel on CUDA tensors and its ``*_plain`` twin
(same signature) on CPU tensors:
  * :func:`conv3x3` — K2 (``csrc/conv.cu``): 3x3 pad-1 conv, stride 1 or 2,
    bias, ReLU, optional residual epilogue ``relu(conv3x3 + b) + conv1x1``,
    input as a list of parts of one storage type (f32, bf16 or uint8
    decoded as raw 0..255 values);
  * :func:`conv_transpose4x4s2` — K3 (``csrc/convt.cu``): 4x4/s2/p1
    transpose conv + bias + ReLU over parts;
  * :func:`conv3x3_chain2` — K4 (``csrc/chain.cu``): two 3x3 conv + bias +
    ReLU stages with the intermediate kept on chip.

Gradients, for the training backward (f32, and bf16 operands in the mixed
schedule except K5):
  * :func:`conv2d_input_grad` — the input cotangent of a stride-1 conv, a
    conv of the output cotangent with the flipped, in/out-transposed kernel
    on K2's K x K stride-1 form (``csrc/conv.cu``, ``nct_conv_kxk``);
  * :func:`conv2d_weight_grad` — the weight cotangent of step 1's
    stride-1 convs on K5 (``csrc/filtergrad.cu``);
  * :func:`conv3x3s2_input_grad` — the input cotangent of a 3x3 stride-2
    conv, a 3x3/s2 transposed conv on K3's 3x3/s2 form (``csrc/convt.cu``,
    ``nct_conv_transpose3x3s2``);
  * :func:`conv_transpose4x4s2_input_grad` — the input cotangent of the
    4x4/s2 transpose conv, a 4x4 stride-2 conv on K2's K x K form at
    stride 2;
  * :func:`conv2d_wgrad` — the weight cotangent of any of the guided net's
    convs (3x3 at stride 1 or 2, and the 4x4/s2 transpose conv) on K6
    (``csrc/wgrad.cu``), its inputs given as parts.

All arithmetic is f32: weights and bias are taken at the values they hold
(the caller rounds them to the compute dtype), inputs are widened on load,
and the output is rounded once to its storage type. An input gradient comes
out in its cotangent's storage type; a weight gradient in f32 (the caller
rounds it to the weight's dtype). A gradient call's tensors share one dtype,
or it raises. The plain versions keep float64 inputs in float64, as a
reference for the f32 paths.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .. import kernels

_FLOAT_OUT = (torch.float32, torch.bfloat16)
_GRAD_DTYPES = (torch.float32, torch.bfloat16, torch.float64)  # f64: plain versions only


def conv2d(x, weight, bias=None, *, stride=1, padding=0, dilation=1, groups=1):
    """``F.conv2d`` with full f32 on the card."""
    with kernels.exact_f32(x):
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


def conv_transpose2d(x, weight, bias=None, *, stride=2, padding=1):
    """``nn.ConvTranspose2d`` semantics; weight (cin, cout, kh, kw)."""
    with kernels.exact_f32(x):
        return F.conv_transpose2d(x, weight, bias, stride=stride, padding=padding)


def _cat_wide(parts):
    parts = [kernels.widen(p) for p in parts]
    return torch.cat(parts, 1) if len(parts) > 1 else parts[0]


def _wide(t):
    return None if t is None else kernels.widen(t)


def _f32(t):
    return None if t is None else t.detach().float().contiguous()


def _grad_dtype(*ts):
    """The one dtype that a gradient call's tensors share; raises on mixed
    or unsupported dtypes."""
    dts = {t.dtype for t in ts}
    if len(dts) != 1 or not dts <= set(_GRAD_DTYPES):
        raise TypeError(f"a gradient call takes one of {_GRAD_DTYPES} throughout; got {sorted(map(str, dts))}")
    return dts.pop()


def _check_same_geometry(parts):
    b, _, h, w = parts[0].shape
    for p in parts:
        if p.dim() != 4 or (p.shape[0], p.shape[2], p.shape[3]) != (b, h, w):
            raise ValueError(f"parts disagree on (B, H, W): {[tuple(q.shape) for q in parts]}")
        if p.dtype != parts[0].dtype:
            raise TypeError(f"parts must share one dtype: {[q.dtype for q in parts]}")
    return b, h, w


# ---------------------------------------------------------------------------
# K2: 3x3 conv
# ---------------------------------------------------------------------------

def conv3x3(
    parts: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    relu: bool = False,
    shortcut: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """3x3 pad-1 conv over the channel concat of ``parts`` (NCHW-indexed,
    any strides). ``shortcut`` (cout, cin, 1, 1) selects the residual form
    ``relu(conv3x3(x) + bias) + conv1x1(x)`` at the same stride (``relu``
    must then be True). ``out_dtype`` defaults to the parts' dtype (f32 for
    uint8 parts)."""
    parts = list(parts)
    _check_same_geometry(parts)
    if out_dtype is None:
        out_dtype = torch.float32 if parts[0].dtype == torch.uint8 else parts[0].dtype
    if shortcut is not None and not relu:
        raise ValueError("the residual form is relu(conv + b) + shortcut")
    if not kernels.on_card(*parts, weight, bias, shortcut):
        return conv3x3_plain(parts, weight, bias, stride=stride, relu=relu,
                             shortcut=shortcut, out_dtype=out_dtype)
    return _conv3x3_kernel(parts, weight, bias, stride, relu, shortcut, out_dtype)


def conv3x3_plain(parts, weight, bias=None, *, stride=1, relu=False,
                  shortcut=None, out_dtype=None):
    """The plain PyTorch version of :func:`conv3x3` (same signature)."""
    parts = list(parts)
    if out_dtype is None:
        out_dtype = torch.float32 if parts[0].dtype == torch.uint8 else parts[0].dtype
    x = _cat_wide(parts)
    y = conv2d(x, _wide(weight), _wide(bias), stride=stride, padding=1)
    if relu:
        y = torch.relu(y)
    if shortcut is not None:
        y = y + conv2d(x, _wide(shortcut), stride=stride)
    return y.to(out_dtype)


def _conv3x3_kernel(parts, weight, bias, stride, relu, shortcut, out_dtype):
    kernels.no_graph("conv3x3", *parts, weight, bias, shortcut)
    b, h, w = _check_same_geometry(parts)
    cout, cin = weight.shape[:2]
    if tuple(weight.shape[2:]) != (3, 3) or sum(p.shape[1] for p in parts) != cin:
        raise ValueError(f"K2 weight {tuple(weight.shape)} does not fit the parts")
    if len(parts) > 4 or stride not in (1, 2):
        raise ValueError("K2 takes at most 4 parts and stride 1 or 2")
    if parts[0].dtype not in kernels.DTYPE_CODE or out_dtype not in _FLOAT_OUT:
        raise TypeError(f"K2 does not take {parts[0].dtype} -> {out_dtype}")
    if parts[0].dtype == torch.float32 and out_dtype != torch.float32:
        raise TypeError("K2 keeps float32 inputs in float32")
    if shortcut is not None and tuple(shortcut.shape) != (cout, cin, 1, 1):
        raise ValueError(f"K2 shortcut {tuple(shortcut.shape)} is not ({cout}, {cin}, 1, 1)")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    w32, b32, s32 = _f32(weight), _f32(bias), _f32(shortcut)
    out = torch.empty((b, cout, ho, wo), device=parts[0].device, dtype=out_dtype)
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    code = kernels.lib().nct_conv3x3(
        ptrs, meta, len(parts), kernels.DTYPE_CODE[parts[0].dtype],
        kernels.DTYPE_CODE[out_dtype], b, h, w, cin, ho, wo, cout, stride,
        w32.data_ptr(), kernels.ptr(s32), kernels.ptr(b32), out.data_ptr(),
        int(relu), kernels.stream_of(out),
    )
    kernels.check(code, "conv3x3 kernel")
    kernels.LAUNCHES["conv"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: 4x4 stride-2 pad-1 transpose conv
# ---------------------------------------------------------------------------

def conv_transpose4x4s2(
    parts: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    relu: bool = True,
) -> torch.Tensor:
    """4x4/s2/p1 transpose conv over the channel concat of ``parts``;
    weight (cin, cout, 4, 4); output (B, cout, 2H, 2W) in the parts' dtype."""
    parts = list(parts)
    _check_same_geometry(parts)
    if not kernels.on_card(*parts, weight, bias):
        return conv_transpose4x4s2_plain(parts, weight, bias, relu=relu)
    return _conv_transpose_kernel(parts, weight, bias, relu)


def conv_transpose4x4s2_plain(parts, weight, bias=None, *, relu=True):
    """The plain PyTorch version of :func:`conv_transpose4x4s2`."""
    parts = list(parts)
    y = conv_transpose2d(_cat_wide(parts), _wide(weight), _wide(bias))
    if relu:
        y = torch.relu(y)
    return y.to(parts[0].dtype)


def _conv_transpose_kernel(parts, weight, bias, relu):
    kernels.no_graph("conv_transpose", *parts, weight, bias)
    b, h, w = _check_same_geometry(parts)
    cin, cout = weight.shape[:2]
    if tuple(weight.shape[2:]) != (4, 4) or sum(p.shape[1] for p in parts) != cin:
        raise ValueError(f"K3 weight {tuple(weight.shape)} does not fit the parts")
    if len(parts) > 4 or parts[0].dtype not in _FLOAT_OUT:
        raise TypeError("K3 takes at most 4 float32 or bfloat16 parts")
    w32, b32 = _f32(weight), _f32(bias)
    out = torch.empty((b, cout, 2 * h, 2 * w), device=parts[0].device, dtype=parts[0].dtype)
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    code = kernels.lib().nct_conv_transpose4x4s2(
        ptrs, meta, len(parts), kernels.DTYPE_CODE[parts[0].dtype], b, h, w,
        cin, cout, w32.data_ptr(), kernels.ptr(b32), out.data_ptr(), int(relu),
        kernels.stream_of(out),
    )
    kernels.check(code, "conv_transpose kernel")
    kernels.LAUNCHES["conv_transpose"] += 1
    return out


# ---------------------------------------------------------------------------
# K4: two-stage conv chain
# ---------------------------------------------------------------------------

def conv3x3_chain2(x, w1, b1, w2, b2) -> torch.Tensor:
    """``relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2)``, pad 1, with
    the intermediate rounded to ``x.dtype`` as a stored tensor would be."""
    if not kernels.on_card(x, w1, b1, w2, b2):
        return conv3x3_chain2_plain(x, w1, b1, w2, b2)
    return _chain_kernel(x, w1, b1, w2, b2)


def conv3x3_chain2_plain(x, w1, b1, w2, b2):
    """The plain PyTorch version of :func:`conv3x3_chain2`."""
    mid = torch.relu(conv2d(x.float(), w1.float(), b1.float(), padding=1)).to(x.dtype)
    y = torch.relu(conv2d(mid.float(), w2.float(), b2.float(), padding=1))
    return y.to(x.dtype)


def _chain_kernel(x, w1, b1, w2, b2):
    kernels.no_graph("conv_chain", x, w1, b1, w2, b2)
    b, cin, h, w = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    if tuple(w1.shape) != (cmid, cin, 3, 3) or tuple(w2.shape) != (cout, cmid, 3, 3):
        raise ValueError(f"K4 weights {tuple(w1.shape)}, {tuple(w2.shape)} do not chain")
    if x.dtype not in _FLOAT_OUT or not x.is_contiguous() or cmid % 8:
        raise ValueError("K4 takes a contiguous float32/bfloat16 input and cmid % 8 == 0")
    out = torch.empty((b, cout, h, w), device=x.device, dtype=x.dtype)
    w1_, b1_, w2_, b2_ = map(_f32, (w1, b1, w2, b2))
    code = kernels.lib().nct_conv_chain2(
        x.data_ptr(), kernels.DTYPE_CODE[x.dtype], b, h, w, cin, cmid, cout,
        w1_.data_ptr(), b1_.data_ptr(), w2_.data_ptr(), b2_.data_ptr(),
        out.data_ptr(), kernels.stream_of(out),
    )
    kernels.check(code, "conv_chain kernel")
    kernels.LAUNCHES["conv_chain"] += 1
    return out


# ---------------------------------------------------------------------------
# Gradients: K2's K x K form (stride 1, and 4x4 at stride 2), K3's 3x3/s2
# form, K5 and K6
# ---------------------------------------------------------------------------

def _input_grad_conv(cot, weight, padding):
    """The conv that gives the input cotangent: ``cot`` against the
    spatially flipped, in/out-transposed kernel at pad ``k - 1 - padding``;
    a negative pad becomes a crop of ``cot`` first."""
    k = weight.shape[-1]
    w_t = weight.flip(2, 3).transpose(0, 1)
    pad = k - 1 - padding
    if pad < 0:
        cot = cot[:, :, -pad:cot.shape[2] + pad, -pad:cot.shape[3] + pad]
        pad = 0
    return cot, w_t, pad


def _check_kxk(x, weight, padding, stride):
    """Raise where K2's K x K form (and so its plain version) does not take
    ``x`` conv ``weight`` at ``padding`` and ``stride``; returns the output
    size."""
    dt = _grad_dtype(x, weight)
    _, cin, h, w = x.shape
    cout, k = weight.shape[0], weight.shape[-1]
    forms = ((3, 1), (4, 2)) if dt == torch.bfloat16 else ((1, 1), (3, 1), (5, 1), (4, 2))
    if (tuple(weight.shape) != (cout, cin, k, k) or (k, stride) not in forms
            or not 0 <= padding < k or min(h, w) + 2 * padding < k):
        raise ValueError(f"K2 k x k form takes (k, stride) in {forms} for {dt}, pad in [0, k); "
                         f"got weight {tuple(weight.shape)}, x {tuple(x.shape)}, stride {stride}, "
                         f"pad {padding}")
    return (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1


def conv2d_input_grad(cot: torch.Tensor, weight: torch.Tensor, padding: int) -> torch.Tensor:
    """Input cotangent (B, cin, H, W) of ``conv2d(x, weight, padding=padding)``
    (stride 1, weight (cout, cin, k, k)) from its output cotangent ``cot``
    (B, cout, Ho, Wo), in ``cot``'s dtype (f32, or bf16 for k = 3)."""
    if not kernels.on_card(cot, weight):
        return conv2d_input_grad_plain(cot, weight, padding)
    cot, w_t, pad = _input_grad_conv(cot, weight, padding)
    return _conv_kxk_kernel(cot, w_t, pad, 1)


def conv2d_input_grad_plain(cot, weight, padding):
    """The plain PyTorch version of :func:`conv2d_input_grad`."""
    cot, w_t, pad = _input_grad_conv(cot, weight, padding)
    _check_kxk(cot, w_t, pad, 1)
    return conv2d(kernels.widen(cot), kernels.widen(w_t), padding=pad).to(cot.dtype)


def conv_transpose4x4s2_input_grad(cot: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Input cotangent (B, cin, H, W) of :func:`conv_transpose4x4s2`
    (weight (cin, cout, 4, 4)) from its output cotangent ``cot``
    (B, cout, 2H, 2W): the 4x4 stride-2 pad-1 conv of ``cot`` with the
    weight read as OIHW, O = cin (no flip). In ``cot``'s dtype."""
    if not kernels.on_card(cot, weight):
        return conv_transpose4x4s2_input_grad_plain(cot, weight)
    return _conv_kxk_kernel(cot, weight, 1, 2)


def conv_transpose4x4s2_input_grad_plain(cot, weight):
    """The plain PyTorch version of :func:`conv_transpose4x4s2_input_grad`."""
    _check_kxk(cot, weight, 1, 2)
    return conv2d(kernels.widen(cot), kernels.widen(weight), stride=2, padding=1).to(cot.dtype)


def _conv_kxk_kernel(x, weight, padding, stride):
    kernels.no_graph("conv_kxk", x, weight)
    ho, wo = _check_kxk(x, weight, padding, stride)
    if x.dtype not in _FLOAT_OUT:
        raise TypeError(f"K2 k x k form takes float32 or bfloat16, got {x.dtype}")
    b, cin, h, w = x.shape
    cout, k = weight.shape[0], weight.shape[-1]
    w32 = _f32(weight)
    out = torch.empty((b, cout, ho, wo), device=x.device, dtype=x.dtype)
    ptrs, meta = kernels.part_args([x], [False])
    code = kernels.lib().nct_conv_kxk(
        ptrs, meta, kernels.DTYPE_CODE[x.dtype], b, h, w, cin, ho, wo, cout, k, stride, padding,
        w32.data_ptr(), out.data_ptr(), kernels.stream_of(out),
    )
    kernels.check(code, "conv_kxk kernel")
    kernels.LAUNCHES["conv_kxk" if stride == 1 else "conv4x4s2"] += 1
    return out


def _check_t3(cot, weight):
    dt = _grad_dtype(cot, weight)
    if weight.dim() != 4 or tuple(weight.shape) != (cot.shape[1], weight.shape[1], 3, 3):
        raise ValueError(f"K3 3x3/s2 form: weight {tuple(weight.shape)} does not fit {tuple(cot.shape)}")
    return dt


def conv3x3s2_input_grad(cot: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Input cotangent (B, cin, 2h, 2w) of a 3x3 stride-2 pad-1 conv of an
    even-sized input (weight (cout, cin, 3, 3)) from its output cotangent
    ``cot`` (B, cout, h, w): the 3x3/s2/p1 transposed conv with
    output_padding 1. In ``cot``'s dtype."""
    if not kernels.on_card(cot, weight):
        return conv3x3s2_input_grad_plain(cot, weight)
    return _conv_transpose3x3s2_kernel(cot, weight)


def conv3x3s2_input_grad_plain(cot, weight):
    """The plain PyTorch version of :func:`conv3x3s2_input_grad`."""
    _check_t3(cot, weight)
    with kernels.exact_f32(cot):
        return F.conv_transpose2d(kernels.widen(cot), kernels.widen(weight), stride=2,
                                  padding=1, output_padding=1).to(cot.dtype)


def _conv_transpose3x3s2_kernel(cot, weight):
    kernels.no_graph("conv_transpose3x3s2", cot, weight)
    if _check_t3(cot, weight) not in _FLOAT_OUT:
        raise TypeError(f"K3 3x3/s2 form takes float32 or bfloat16, got {cot.dtype}")
    b, cin, h, w = cot.shape
    cout = weight.shape[1]
    w32 = _f32(weight)
    out = torch.empty((b, cout, 2 * h, 2 * w), device=cot.device, dtype=cot.dtype)
    ptrs, meta = kernels.part_args([cot], [False])
    code = kernels.lib().nct_conv_transpose3x3s2(
        ptrs, meta, kernels.DTYPE_CODE[cot.dtype], b, h, w, cin, cout, w32.data_ptr(),
        out.data_ptr(), kernels.stream_of(out),
    )
    kernels.check(code, "conv_transpose3x3s2 kernel")
    kernels.LAUNCHES["conv_transpose3x3s2"] += 1
    return out


def _weight_grad_pads(x, g, ksize, padding, pad_top, stride=1):
    """(pad_top, pad_bottom, pad_left, pad_right) of the forward conv at
    ``stride``, the bottom and right pads implied by the output size."""
    (b, _, h, w), (bg, _, ho, wo) = x.shape, g.shape
    pads = (pad_top, stride * (ho - 1) + ksize - h - pad_top,
            padding, stride * (wo - 1) + ksize - w - padding)
    if b != bg or min(pads) < 0:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} are not a stride-{stride} "
                         f"{ksize}x{ksize} conv at pads {pads}")
    return pads


def conv2d_weight_grad(
    x: torch.Tensor, g: torch.Tensor, ksize: int, padding: int, pad_top: int | None = None
) -> torch.Tensor:
    """Weight cotangent (cout, cin, k, k), f32, of a stride-1 conv: ``x``
    (B, cin, H, W) is its input and ``g`` (B, cout, Ho, Wo) its output
    cotangent. ``padding`` is the left pad and, unless ``pad_top`` is given,
    the top pad; the bottom and right pads follow from (Ho, Wo)."""
    pad_top = padding if pad_top is None else pad_top
    _weight_grad_pads(x, g, ksize, padding, pad_top)
    if not kernels.on_card(x, g):
        return conv2d_weight_grad_plain(x, g, ksize, padding, pad_top)
    return _filtergrad_kernel(x, g, ksize, padding, pad_top)


def conv2d_weight_grad_plain(x, g, ksize, padding, pad_top=None, *, stride=1):
    """The plain PyTorch version of :func:`conv2d_weight_grad` and, with
    ``x`` and ``g`` as lists of parts, of :func:`conv2d_wgrad`: one
    contraction over (B, Ho, Wo) per tap."""
    xs, gs = ([t] if isinstance(t, torch.Tensor) else list(t) for t in (x, g))
    _grad_dtype(*xs, *gs)
    x, g = _cat_wide(xs), _cat_wide(gs)
    pad_top = padding if pad_top is None else pad_top
    pt, pb, pl, pr = _weight_grad_pads(x, g, ksize, padding, pad_top, stride)
    ho, wo = g.shape[2:]
    rows, cols = stride * (ho - 1) + 1, stride * (wo - 1) + 1
    xp = F.pad(x, (pl, pr, pt, pb))
    dw = g.new_empty((g.shape[1], x.shape[1], ksize, ksize))
    with kernels.exact_f32(x):
        for dy in range(ksize):
            for dx in range(ksize):
                dw[:, :, dy, dx] = torch.einsum(
                    "bchw,bohw->oc", xp[:, :, dy:dy + rows:stride, dx:dx + cols:stride], g)
    return dw


def _filtergrad_kernel(x, g, ksize, padding, pad_top):
    kernels.no_graph("filtergrad", x, g)
    b, cin, h, w = x.shape
    cout, ho, wo = g.shape[1:]
    if ksize not in (1, 3, 5) or cout not in (1, 8):
        raise ValueError(f"K5 takes k in (1, 3, 5) and cout in (1, 8); got k {ksize}, cout {cout}")
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"K5 takes float32, got {x.dtype} and {g.dtype}")
    x, g = x.contiguous(), g.contiguous()
    lib = kernels.lib()
    part = torch.empty((lib.nct_filtergrad_tiles(b, ho, wo), cout * cin * ksize * ksize),
                       device=x.device)
    out = torch.empty((cout, cin, ksize, ksize), device=x.device)
    code = lib.nct_filtergrad(
        x.data_ptr(), g.data_ptr(), b, cin, h, w, cout, ho, wo, ksize, pad_top,
        padding, part.data_ptr(), out.data_ptr(), kernels.stream_of(out),
    )
    kernels.check(code, "filtergrad kernel")
    kernels.LAUNCHES["filtergrad"] += 1
    return out


def conv2d_wgrad(
    x_parts: Sequence[torch.Tensor],
    g_parts: Sequence[torch.Tensor],
    ksize: int,
    *,
    stride: int = 1,
    padding: int,
) -> torch.Tensor:
    """Weight cotangent (M, cin, k, k), f32, of a k x k conv at ``stride``
    and symmetric pad ``padding``: ``x_parts`` are the parts of its input
    (B, c_i, H, W) and ``g_parts`` of its output cotangent (B, m_i, Ho, Wo),
    each a logical channel concat, all f32 or all bf16. With the roles swapped (x the output
    cotangent of :func:`conv_transpose4x4s2`, g its input, k 4, stride 2,
    pad 1) it is that transpose conv's weight cotangent, (cin, cout, 4, 4)."""
    x_parts, g_parts = list(x_parts), list(g_parts)
    _check_same_geometry(x_parts)
    _check_same_geometry(g_parts)
    _weight_grad_pads(x_parts[0], g_parts[0], ksize, padding, padding, stride)
    if not kernels.on_card(*x_parts, *g_parts):
        return conv2d_weight_grad_plain(x_parts, g_parts, ksize, padding, stride=stride)
    return _wgrad_kernel(x_parts, g_parts, ksize, stride, padding)


def _wgrad_kernel(x_parts, g_parts, ksize, stride, padding):
    kernels.no_graph("wgrad", *x_parts, *g_parts)
    b, h, w = _check_same_geometry(x_parts)
    ho, wo = g_parts[0].shape[2:]
    if ((ksize, stride) not in ((3, 1), (3, 2), (4, 2)) or max(len(x_parts), len(g_parts)) > 4
            or not 0 <= padding < ksize
            or (ho, wo) != ((h + 2 * padding - ksize) // stride + 1, (w + 2 * padding - ksize) // stride + 1)):
        raise ValueError(f"K6 takes (k, stride) in (3, 1), (3, 2), (4, 2), pad in [0, k), at most 4 parts "
                         f"a side and the conv's own output size; got k {ksize}, stride {stride}, pad "
                         f"{padding}, x {tuple(x_parts[0].shape)}, g {tuple(g_parts[0].shape)}")
    if _grad_dtype(*x_parts, *g_parts) not in _FLOAT_OUT:
        raise TypeError("K6 takes float32 or bfloat16 parts")
    cin, m = sum(p.shape[1] for p in x_parts), sum(p.shape[1] for p in g_parts)
    lib = kernels.lib()
    part = torch.empty((lib.nct_wgrad_slices(b, ho, wo, m, cin * ksize * ksize), m, cin * ksize * ksize),
                       device=x_parts[0].device)
    out = torch.empty((m, cin, ksize, ksize), device=x_parts[0].device)
    gptrs, gmeta = kernels.part_args(g_parts, [False] * len(g_parts))
    xptrs, xmeta = kernels.part_args(x_parts, [False] * len(x_parts))
    code = lib.nct_wgrad(
        gptrs, gmeta, len(g_parts), xptrs, xmeta, len(x_parts), kernels.DTYPE_CODE[x_parts[0].dtype],
        b, m, cin, h, w, ho, wo,
        ksize, stride, padding, part.data_ptr(), out.data_ptr(), kernels.stream_of(out),
    )
    kernels.check(code, "wgrad kernel")
    kernels.LAUNCHES["wgrad"] += 1
    return out
