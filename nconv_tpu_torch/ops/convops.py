"""Convolutions, NCHW activations with torch weight layouts.

Plain ops: :func:`conv2d` (OIHW) and :func:`conv_transpose2d`
(``nn.ConvTranspose2d`` semantics, weight (cin, cout, kh, kw)).

Fused layer ops, each a kernel on CUDA tensors and its ``*_plain`` twin
(same signature) on CPU tensors:
  * :func:`conv3x3` — K2: 3x3 pad-1 conv, stride 1 or 2, bias, ReLU,
    optional residual epilogue ``relu(conv3x3 + b) + conv1x1``, input as a
    list of parts of one storage type (f32, bf16 or uint8 decoded as raw
    0..255 values). bf16 parts with a bf16 output and cout >= 8 run on the
    tensor cores (``csrc/conv_tc.cu``, counter ``conv_tc``); a bf16 output
    at stride 1 from uint8 parts (the mixed schedule's frame encoder) or
    from bf16 parts with cout < 8 (its depth heads) on the thin CUDA-core
    form (``csrc/conv_thin.cu``, counter ``conv_thin``); every other call
    on the CUDA cores (``csrc/conv.cu``, counter ``conv``): f32 parts and
    uint8 parts with an f32 output on the output-stationary kernel that the
    K x K backward form shares (all output channels a block, channel chunks
    staged by ``cp.async`` two deep, a cout-1 tile for the heads), the
    bf16 forms no recorded path reaches on a simple template;
  * :func:`conv_transpose4x4s2` — K3: 4x4/s2/p1 transpose conv + bias +
    ReLU over parts; bf16 on the tensor cores (``csrc/conv_tc.cu``,
    ``conv_transpose_tc``), f32 on the CUDA cores (``csrc/convt.cu``,
    ``conv_transpose``: 2x2 output quads over up to 32 output channels a
    block, the real channels staged two deep);
  * :func:`conv3x3_chain2` — K4: two 3x3 conv + bias + ReLU stages with
    the intermediate kept on chip; bf16 on the tensor cores
    (``csrc/conv_chain_tc.cu``, ``conv_chain_tc``), f32 on the CUDA cores
    (``csrc/chain.cu``, ``conv_chain``).

Gradients, for the training backward (f32, and bf16 operands in the mixed
schedule except K5):
  * :func:`conv2d_input_grad` — the input cotangent of a stride-1 conv, a
    conv of the output cotangent with the flipped, in/out-transposed kernel:
    f32 on K2's K x K stride-1 form (``csrc/conv.cu``, ``nct_conv_kxk``,
    counter ``conv_kxk``, reading the forward weight flipped as it stages
    it), bf16 (3x3 pad 1) on the tensor cores (mode 0 of
    ``csrc/conv_tc.cu`` reading the forward weight flipped as it stages it,
    counter ``conv_input_grad_tc``);
  * :func:`conv2d_weight_grad` — the weight cotangent of step 1's
    stride-1 convs on K5 (``csrc/filtergrad.cu``, counter ``filtergrad``:
    register tiles over the real (channel, dy) pairs, a dot form for the
    1x1 cout-1 head, slices summed in a fixed order);
  * :func:`conv3x3s2_input_grad` — the input cotangent of a 3x3 stride-2
    conv, a 3x3/s2 transposed conv: f32 on K3's 3x3/s2 form
    (``csrc/convt.cu``, counter ``conv_transpose3x3s2``: 2x2 output quads
    over all output channels a block, staged two deep), bf16 on the
    tensor cores (mode 3 of ``csrc/conv_tc.cu``, counter
    ``conv_transpose3x3s2_tc``);
  * :func:`conv_transpose4x4s2_input_grad` — the input cotangent of the
    4x4/s2 transpose conv, a 4x4 stride-2 conv: f32 on K2's K x K form at
    stride 2 (counter ``conv4x4s2``), bf16 on the tensor cores (mode 4 of
    ``csrc/conv_tc.cu``, counter ``conv4x4s2_tc``);
  * :func:`conv2d_wgrad` — the weight cotangent of any of the guided net's
    convs (3x3 at stride 1 or 2, and the 4x4/s2 transpose conv), its inputs
    given as parts: f32 on K6 (``csrc/wgrad.cu``, counter ``wgrad``), bf16
    on the tensor cores (``csrc/wgrad_tc.cu``, counter ``wgrad_tc``).

All arithmetic is f32: inputs are widened on load and the output is
rounded once to its storage type. Bias is taken at the value it holds;
weights too, except that the forward convs on bf16 parts round them to bf16
(nearest even) first, as JAX's mixed schedule casts its kernel to the
compute dtype; the tensor-core forms do so as they stage the weight from its
stored type (f32 or bf16). An input gradient comes
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


def _stored(t):
    return None if t is None else t.detach().contiguous()


def _round_for(parts, t):
    """Weight ``t`` as a forward conv over ``parts`` reads it: rounded to
    bf16 for bf16 parts, else as held."""
    if t is None or parts[0].dtype != torch.bfloat16:
        return t
    return t.to(torch.bfloat16)


def _weight_code(t, what):
    if t.dtype not in _FLOAT_OUT:
        raise TypeError(f"{what}: the tensor-core form reads f32 or bf16 weights, got {t.dtype}")
    return kernels.DTYPE_CODE[t.dtype]


def on_tensor_cores(parts_dtype: torch.dtype, out_dtype: torch.dtype, cout: int) -> bool:
    """Whether :func:`conv3x3` runs a call on the tensor-core form of K2
    (bf16 parts, bf16 output, at least 8 output channels)."""
    return parts_dtype == torch.bfloat16 and out_dtype == torch.bfloat16 and cout >= 8


def on_thin(parts_dtype: torch.dtype, out_dtype: torch.dtype, cout: int, stride: int) -> bool:
    """Whether :func:`conv3x3` runs a call on the thin CUDA-core form (a
    bf16 output at stride 1 from uint8 parts, or from bf16 parts with fewer
    than 8 output channels)."""
    return stride == 1 and out_dtype == torch.bfloat16 and (
        parts_dtype == torch.uint8 or (parts_dtype == torch.bfloat16 and cout < 8))


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
    if torch.compiler.is_exporting():
        from . import library
        return library.conv3x3(parts, weight, bias, stride, relu, shortcut, out_dtype)
    if not kernels.on_card(*parts, weight, bias, shortcut):
        return conv3x3_plain(parts, weight, bias, stride=stride, relu=relu,
                             shortcut=shortcut, out_dtype=out_dtype)
    return _conv3x3_on_card(parts, weight, bias, stride, relu, shortcut, out_dtype)


def _conv3x3_on_card(parts, weight, bias, stride, relu, shortcut, out_dtype):
    """The kernel of :func:`conv3x3`'s form for this call: the tensor
    cores, the thin form or the CUDA-core form."""
    if on_tensor_cores(parts[0].dtype, out_dtype, weight.shape[0]):
        return _conv_tc_kernel(parts, weight, bias, stride, relu, shortcut)
    if on_thin(parts[0].dtype, out_dtype, weight.shape[0], stride):
        return _conv_thin_kernel(parts, weight, bias, relu, shortcut)
    return _conv3x3_kernel(parts, weight, bias, stride, relu, shortcut, out_dtype)


def conv3x3_plain(parts, weight, bias=None, *, stride=1, relu=False,
                  shortcut=None, out_dtype=None):
    """The plain PyTorch version of :func:`conv3x3` (same signature)."""
    parts = list(parts)
    if out_dtype is None:
        out_dtype = torch.float32 if parts[0].dtype == torch.uint8 else parts[0].dtype
    x = _cat_wide(parts)
    y = conv2d(x, _wide(_round_for(parts, weight)), _wide(bias), stride=stride, padding=1)
    if relu:
        y = torch.relu(y)
    if shortcut is not None:
        y = y + conv2d(x, _wide(_round_for(parts, shortcut)), stride=stride)
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
    if on_tensor_cores(parts[0].dtype, out_dtype, cout):
        raise ValueError("bf16 -> bf16 convs with cout >= 8 run on the tensor-core form (conv_tc)")
    if on_thin(parts[0].dtype, out_dtype, cout, stride):
        raise ValueError("stride-1 uint8 -> bf16 convs and bf16 heads run on the thin form (conv_thin)")
    if shortcut is not None and tuple(shortcut.shape) != (cout, cin, 1, 1):
        raise ValueError(f"K2 shortcut {tuple(shortcut.shape)} is not ({cout}, {cin}, 1, 1)")
    if shortcut is not None and parts[0].dtype == out_dtype == torch.bfloat16:
        raise ValueError("K2's CUDA-core form has no bf16 residual form below 8 channels")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    w32, b32, s32 = _f32(_round_for(parts, weight)), _f32(bias), _f32(_round_for(parts, shortcut))
    out = torch.empty((b, cout, ho, wo), device=parts[0].device, dtype=out_dtype)
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    kernels.launch("conv", "nct_conv3x3", out, ptrs, meta, len(parts), kernels.DTYPE_CODE[parts[0].dtype],
                   kernels.DTYPE_CODE[out_dtype], b, h, w, cin, ho, wo, cout, stride, w32, s32, b32, out,
                   int(relu))
    return out


def _conv_thin_kernel(parts, weight, bias, relu, shortcut):
    kernels.no_graph("conv_thin", *parts, weight, bias, shortcut)
    b, h, w = _check_same_geometry(parts)
    cout, cin = weight.shape[:2]
    u8 = parts[0].dtype == torch.uint8
    if tuple(weight.shape[2:]) != (3, 3) or sum(p.shape[1] for p in parts) != cin:
        raise ValueError(f"K2 weight {tuple(weight.shape)} does not fit the parts")
    if len(parts) > 4 or not on_thin(parts[0].dtype, torch.bfloat16, cout, 1):
        raise ValueError("the thin form takes at most 4 uint8 parts, or bf16 parts with cout < 8, to bf16")
    if (cin > 4) if u8 else (cin > 256 or shortcut is not None):
        raise ValueError("the thin form decodes at most 4 uint8 channels, and its bf16 form takes at most "
                         "256 channels and no shortcut")
    if shortcut is not None and tuple(shortcut.shape) != (cout, cin, 1, 1):
        raise ValueError(f"K2 shortcut {tuple(shortcut.shape)} is not ({cout}, {cin}, 1, 1)")
    # as stored: the kernel reads the weights rounded to bf16 over bf16 parts
    # (as _round_for), as stored over uint8 parts, the bias as stored
    wt, st, bt = (None if t is None else t.contiguous() for t in (weight, shortcut, bias))
    if len({t.dtype for t in (wt, st, bt) if t is not None}) != 1:
        raise TypeError("the thin form reads its weights and bias in one dtype")
    out = torch.empty((b, cout, h, w), device=parts[0].device, dtype=torch.bfloat16)
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    kernels.launch("conv_thin", "nct_conv_thin", out, ptrs, meta, len(parts), kernels.DTYPE_CODE[parts[0].dtype],
                   b, h, w, cin, cout, wt, st, bt, _weight_code(wt, "conv_thin"), out, int(relu))
    return out


def _conv_tc_kernel(parts, weight, bias, stride, relu, shortcut):
    kernels.no_graph("conv_tc", *parts, weight, bias, shortcut)
    b, h, w = _check_same_geometry(parts)
    cout, cin = weight.shape[:2]
    if tuple(weight.shape[2:]) != (3, 3) or sum(p.shape[1] for p in parts) != cin:
        raise ValueError(f"K2 weight {tuple(weight.shape)} does not fit the parts")
    if len(parts) > 4 or stride not in (1, 2) or parts[0].dtype != torch.bfloat16:
        raise ValueError("K2's tensor-core form takes at most 4 bf16 parts and stride 1 or 2")
    if shortcut is not None and (tuple(shortcut.shape) != (cout, cin, 1, 1) or shortcut.dtype != weight.dtype):
        raise ValueError(f"K2 shortcut {tuple(shortcut.shape)} {shortcut.dtype} is not ({cout}, {cin}, 1, 1) "
                         f"{weight.dtype}")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    wt, bt, st = _stored(weight), _stored(bias), _stored(shortcut)
    out = torch.empty((b, cout, ho, wo), device=parts[0].device, dtype=torch.bfloat16)
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    kernels.launch("conv_tc", "nct_conv_tc", out, ptrs, meta, len(parts), b, h, w, cin, cout, stride - 1, wt,
                   _weight_code(wt, "conv_tc"), 0, st, bt, 0 if bt is None else _weight_code(bt, "conv_tc"), out,
                   int(relu))
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
    if torch.compiler.is_exporting():
        from . import library
        return library.conv_transpose4x4s2(parts, weight, bias, relu)
    if not kernels.on_card(*parts, weight, bias):
        return conv_transpose4x4s2_plain(parts, weight, bias, relu=relu)
    return _conv_transpose4x4s2_on_card(parts, weight, bias, relu)


def _conv_transpose4x4s2_on_card(parts, weight, bias, relu):
    if parts[0].dtype == torch.bfloat16:
        return _conv_transpose_tc_kernel(parts, weight, bias, relu)
    return _conv_transpose_kernel(parts, weight, bias, relu)


def conv_transpose4x4s2_plain(parts, weight, bias=None, *, relu=True):
    """The plain PyTorch version of :func:`conv_transpose4x4s2`."""
    parts = list(parts)
    y = conv_transpose2d(_cat_wide(parts), _wide(_round_for(parts, weight)), _wide(bias))
    if relu:
        y = torch.relu(y)
    return y.to(parts[0].dtype)


def _conv_transpose_kernel(parts, weight, bias, relu):
    kernels.no_graph("conv_transpose", *parts, weight, bias)
    b, h, w = _check_same_geometry(parts)
    cin, cout = weight.shape[:2]
    if tuple(weight.shape[2:]) != (4, 4) or sum(p.shape[1] for p in parts) != cin:
        raise ValueError(f"K3 weight {tuple(weight.shape)} does not fit the parts")
    if len(parts) > 4 or parts[0].dtype != torch.float32:
        raise TypeError("K3's CUDA-core form takes at most 4 float32 parts (bf16: conv_transpose_tc)")
    w32, b32 = _f32(weight), _f32(bias)
    out = torch.empty((b, cout, 2 * h, 2 * w), device=parts[0].device, dtype=parts[0].dtype)
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    kernels.launch("conv_transpose", "nct_conv_transpose4x4s2", out, ptrs, meta, len(parts),
                   kernels.DTYPE_CODE[parts[0].dtype], b, h, w, cin, cout, w32, b32, out, int(relu))
    return out


def _conv_transpose_tc_kernel(parts, weight, bias, relu):
    kernels.no_graph("conv_transpose_tc", *parts, weight, bias)
    b, h, w = _check_same_geometry(parts)
    cin, cout = weight.shape[:2]
    if tuple(weight.shape[2:]) != (4, 4) or sum(p.shape[1] for p in parts) != cin:
        raise ValueError(f"K3 weight {tuple(weight.shape)} does not fit the parts")
    if len(parts) > 4 or parts[0].dtype != torch.bfloat16:
        raise TypeError("K3's tensor-core form takes at most 4 bf16 parts")
    wt, bt = _stored(weight), _stored(bias)
    out = torch.empty((b, cout, 2 * h, 2 * w), device=parts[0].device, dtype=torch.bfloat16)
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    kernels.launch("conv_transpose_tc", "nct_conv_tc", out, ptrs, meta, len(parts), b, h, w, cin, cout, 2, wt,
                   _weight_code(wt, "conv_transpose_tc"), 0, None, bt,
                   0 if bt is None else _weight_code(bt, "conv_transpose_tc"), out, int(relu))
    return out


# ---------------------------------------------------------------------------
# K4: two-stage conv chain
# ---------------------------------------------------------------------------

def conv3x3_chain2(x, w1, b1, w2, b2) -> torch.Tensor:
    """``relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2)``, pad 1, with
    the intermediate rounded to ``x.dtype`` as a stored tensor would be; on
    a bf16 ``x`` the weights are read rounded to bf16 (as :func:`conv3x3`
    reads them), the biases as held.

    On the card both forms (f32 ``csrc/chain.cu``, bf16
    ``csrc/conv_chain_tc.cu``) take cmid and cout up to 64, the fusion
    stages' widths: a block holds every intermediate channel of its tile in
    shared memory, run as 32 or 64 channels. A wider chain raises."""
    if torch.compiler.is_exporting():
        from . import library
        return library.conv3x3_chain2(x, w1, b1, w2, b2)
    if not kernels.on_card(x, w1, b1, w2, b2):
        return conv3x3_chain2_plain(x, w1, b1, w2, b2)
    return _conv3x3_chain2_on_card(x, w1, b1, w2, b2)


def _conv3x3_chain2_on_card(x, w1, b1, w2, b2):
    if x.dtype == torch.bfloat16:
        return _chain_tc_kernel(x, w1, b1, w2, b2)
    return _chain_kernel(x, w1, b1, w2, b2)


def conv3x3_chain2_plain(x, w1, b1, w2, b2):
    """The plain PyTorch version of :func:`conv3x3_chain2`."""
    w1, w2 = (_wide(_round_for([x], t)) for t in (w1, w2))
    mid = torch.relu(conv2d(kernels.widen(x), w1, _wide(b1), padding=1)).to(x.dtype)
    y = torch.relu(conv2d(kernels.widen(mid), w2, _wide(b2), padding=1))
    return y.to(x.dtype)


def _check_chain(x, w1, w2):
    b, cin, h, w = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    if tuple(w1.shape) != (cmid, cin, 3, 3) or tuple(w2.shape) != (cout, cmid, 3, 3):
        raise ValueError(f"K4 weights {tuple(w1.shape)}, {tuple(w2.shape)} do not chain")
    if not x.is_contiguous():
        raise ValueError("K4 takes a contiguous input")
    return b, cin, h, w, cmid, cout


def _chain_kernel(x, w1, b1, w2, b2):
    kernels.no_graph("conv_chain", x, w1, b1, w2, b2)
    b, cin, h, w, cmid, cout = _check_chain(x, w1, w2)
    if x.dtype != torch.float32 or not (1 <= cmid <= 64 and 1 <= cout <= 64):
        raise ValueError("K4's CUDA-core form takes float32 (bf16: conv_chain_tc) and cmid, cout up to 64")
    out = torch.empty((b, cout, h, w), device=x.device, dtype=x.dtype)
    kernels.launch("conv_chain", "nct_conv_chain2", out, x, kernels.DTYPE_CODE[x.dtype], b, h, w, cin, cmid, cout,
                   *map(_f32, (w1, b1, w2, b2)), out)
    return out


def _chain_tc_kernel(x, w1, b1, w2, b2):
    kernels.no_graph("conv_chain_tc", x, w1, b1, w2, b2)
    b, cin, h, w, cmid, cout = _check_chain(x, w1, w2)
    ws = [_stored(t) for t in (w1, b1, w2, b2)]
    if x.dtype != torch.bfloat16 or not (1 <= cmid <= 64 and 1 <= cout <= 64):
        raise ValueError("K4's tensor-core form takes bfloat16 and cmid, cout up to 64")
    if len({t.dtype for t in ws}) != 1:
        raise TypeError(f"K4's tensor-core form reads its weights and biases in one dtype, got "
                        f"{[t.dtype for t in ws]}")
    out = torch.empty((b, cout, h, w), device=x.device, dtype=torch.bfloat16)
    kernels.launch("conv_chain_tc", "nct_conv_chain_tc", out, x, b, h, w, cin, cmid, cout, *ws,
                   _weight_code(ws[0], "conv_chain_tc"), out)
    return out


# ---------------------------------------------------------------------------
# Gradients: K2's K x K form (stride 1, and 4x4 at stride 2), K3's 3x3/s2
# form, K5 and K6
# ---------------------------------------------------------------------------

def _input_grad_crop(cot, k, padding):
    """``cot`` and the pad ``k - 1 - padding`` of the conv that gives the
    input cotangent; a negative pad becomes a crop of ``cot`` (a view)."""
    pad = k - 1 - padding
    if pad < 0:
        cot = cot[:, :, -pad:cot.shape[2] + pad, -pad:cot.shape[3] + pad]
        pad = 0
    return cot, pad


def _input_grad_conv(cot, weight, padding):
    """The conv that gives the input cotangent: ``cot`` against the
    spatially flipped, in/out-transposed kernel at pad ``k - 1 - padding``;
    a negative pad becomes a crop of ``cot`` first."""
    cot, pad = _input_grad_crop(cot, weight.shape[-1], padding)
    return cot, weight.flip(2, 3).transpose(0, 1), pad


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
    if cot.dtype == torch.bfloat16:
        return _conv_input_grad_tc_kernel(cot, weight, padding)
    cot, pad = _input_grad_crop(cot, weight.shape[-1], padding)
    return _conv_kxk_kernel(cot, weight, pad, 1)


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
    if cot.dtype == torch.bfloat16:
        return _conv4x4s2_tc_kernel(cot, weight)
    return _conv_kxk_kernel(cot, weight, 1, 2)


def conv_transpose4x4s2_input_grad_plain(cot, weight):
    """The plain PyTorch version of :func:`conv_transpose4x4s2_input_grad`."""
    _check_kxk(cot, weight, 1, 2)
    return conv2d(kernels.widen(cot), kernels.widen(weight), stride=2, padding=1).to(cot.dtype)


def _conv_kxk_kernel(x, weight, padding, stride):
    """K2's CUDA-core K x K form at ``padding`` and ``stride``. Stride 1: the
    input cotangent's conv, ``weight`` the forward conv's (cin, cout, k, k)
    as stored, which the kernel reads flipped and in/out-transposed, so no
    call copies it. Stride 2: ``x`` conv ``weight`` (cout, cin, 4, 4) as
    OIHW (the transpose conv's weight as stored)."""
    kernels.no_graph("conv_kxk", x, weight)
    ho, wo = _check_kxk(x, weight.transpose(0, 1) if stride == 1 else weight, padding, stride)
    if x.dtype != torch.float32:
        raise TypeError(f"K2's CUDA-core k x k form takes float32 (bf16: conv_input_grad_tc, conv4x4s2_tc), "
                        f"got {x.dtype}")
    b, cin, h, w = x.shape
    cout, k = weight.shape[1 if stride == 1 else 0], weight.shape[-1]
    out = torch.empty((b, cout, ho, wo), device=x.device, dtype=x.dtype)
    ptrs, meta = kernels.part_args([x], [False])
    kernels.launch("conv_kxk" if stride == 1 else "conv4x4s2", "nct_conv_kxk", out, ptrs, meta,
                   kernels.DTYPE_CODE[x.dtype], b, h, w, cin, ho, wo, cout, k, stride, padding, _f32(weight), out)
    return out


def _conv_input_grad_tc_kernel(cot, weight, padding):
    """The bf16 input cotangent of a 3x3 pad-1 stride-1 conv on the tensor
    cores: mode 0 of ``nct_conv_tc`` reading the forward ``weight`` (cout,
    cin, 3, 3) as stored, flipped and in/out-transposed as it stages it."""
    kernels.no_graph("conv_input_grad_tc", cot, weight)
    if _grad_dtype(cot, weight) != torch.bfloat16:
        raise TypeError(f"the tensor-core stride-1 input-gradient form takes bfloat16, got {cot.dtype}")
    b, cout, h, w = cot.shape
    cin = weight.shape[1]
    if tuple(weight.shape) != (cout, cin, 3, 3) or padding != 1 or cin > 128:
        raise ValueError(f"the tensor-core stride-1 input-gradient form takes a 3x3 pad-1 conv's weight with "
                         f"at most 128 input channels; got weight {tuple(weight.shape)}, cotangent "
                         f"{tuple(cot.shape)}, pad {padding}")
    wt = _stored(weight)
    out = torch.empty((b, cin, h, w), device=cot.device, dtype=torch.bfloat16)
    ptrs, meta = kernels.part_args([cot], [False])
    kernels.launch("conv_input_grad_tc", "nct_conv_tc", out, ptrs, meta, 1, b, h, w, cout, cin, 0, wt,
                   _weight_code(wt, "conv_input_grad_tc"), 1, None, None, 0, out, 0)
    return out


def _conv4x4s2_tc_kernel(cot, weight):
    """The bf16 input cotangent of the 4x4/s2/p1 transpose conv on the
    tensor cores: mode 4 of ``nct_conv_tc``, the 4x4 stride-2 pad-1 conv of
    ``cot`` with ``weight`` (cin, cout, 4, 4) read as OIHW."""
    kernels.no_graph("conv4x4s2_tc", cot, weight)
    if _grad_dtype(cot, weight) != torch.bfloat16:
        raise TypeError(f"the tensor-core 4x4/s2 input-gradient form takes bfloat16, got {cot.dtype}")
    ho, wo = _check_kxk(cot, weight, 1, 2)
    b, cin, h, w = cot.shape
    cout = weight.shape[0]
    wt = _stored(weight)
    out = torch.empty((b, cout, ho, wo), device=cot.device, dtype=torch.bfloat16)
    ptrs, meta = kernels.part_args([cot], [False])
    kernels.launch("conv4x4s2_tc", "nct_conv_tc", out, ptrs, meta, 1, b, h, w, cin, cout, 4, wt,
                   _weight_code(wt, "conv4x4s2_tc"), 0, None, None, 0, out, 0)
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
    if cot.dtype == torch.bfloat16:
        return _conv_transpose3x3s2_tc_kernel(cot, weight)
    return _conv_transpose3x3s2_kernel(cot, weight)


def conv3x3s2_input_grad_plain(cot, weight):
    """The plain PyTorch version of :func:`conv3x3s2_input_grad`."""
    _check_t3(cot, weight)
    with kernels.exact_f32(cot):
        return F.conv_transpose2d(kernels.widen(cot), kernels.widen(weight), stride=2,
                                  padding=1, output_padding=1).to(cot.dtype)


def _conv_transpose3x3s2_kernel(cot, weight):
    kernels.no_graph("conv_transpose3x3s2", cot, weight)
    if _check_t3(cot, weight) != torch.float32:
        raise TypeError(f"K3's CUDA-core 3x3/s2 form takes float32 (bf16: conv_transpose3x3s2_tc), "
                        f"got {cot.dtype}")
    b, cin, h, w = cot.shape
    cout = weight.shape[1]
    out = torch.empty((b, cout, 2 * h, 2 * w), device=cot.device, dtype=cot.dtype)
    ptrs, meta = kernels.part_args([cot], [False])
    kernels.launch("conv_transpose3x3s2", "nct_conv_transpose3x3s2", out, ptrs, meta,
                   kernels.DTYPE_CODE[cot.dtype], b, h, w, cin, cout, _f32(weight), out)
    return out


def _conv_transpose3x3s2_tc_kernel(cot, weight):
    kernels.no_graph("conv_transpose3x3s2_tc", cot, weight)
    if _check_t3(cot, weight) != torch.bfloat16:
        raise TypeError(f"the tensor-core 3x3/s2 form takes bfloat16, got {cot.dtype}")
    b, cin, h, w = cot.shape
    cout = weight.shape[1]
    if cout > 64:
        raise ValueError(f"the tensor-core 3x3/s2 form takes at most 64 output channels, got {cout}")
    wt = _stored(weight)
    out = torch.empty((b, cout, 2 * h, 2 * w), device=cot.device, dtype=torch.bfloat16)
    ptrs, meta = kernels.part_args([cot], [False])
    kernels.launch("conv_transpose3x3s2_tc", "nct_conv_tc", out, ptrs, meta, 1, b, h, w, cin, cout, 3, wt,
                   _weight_code(wt, "conv_transpose3x3s2_tc"), 0, None, None, 0, out, 0)
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
    with kernels.device_guard(x):  # the plan's slices fill x's card
        slices = kernels.lib().nct_filtergrad_slices(b, cin, h, ho, wo, cout, ksize)
    if slices < 1:
        raise RuntimeError(f"filtergrad plan: CUDA error {-slices}")
    part = torch.empty((slices, cout * cin * ksize * ksize), device=x.device)
    out = torch.empty((cout, cin, ksize, ksize), device=x.device)
    kernels.launch("filtergrad", "nct_filtergrad", out, x, g, b, cin, h, w, cout, ho, wo, ksize, pad_top, padding,
                   part, out)
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
    if x_parts[0].dtype == torch.bfloat16:
        return _wgrad_tc_kernel(x_parts, g_parts, ksize, stride, padding)
    return _wgrad_kernel(x_parts, g_parts, ksize, stride, padding)


def _check_wgrad(x_parts, g_parts, ksize, stride, padding, dtype, form):
    """Raise where K6's ``form`` does not take the call; returns (b, h, w,
    ho, wo, cin, m)."""
    b, h, w = _check_same_geometry(x_parts)
    ho, wo = g_parts[0].shape[2:]
    if ((ksize, stride) not in ((3, 1), (3, 2), (4, 2)) or max(len(x_parts), len(g_parts)) > 4
            or not 0 <= padding < ksize
            or (ho, wo) != ((h + 2 * padding - ksize) // stride + 1, (w + 2 * padding - ksize) // stride + 1)):
        raise ValueError(f"{form} takes (k, stride) in (3, 1), (3, 2), (4, 2), pad in [0, k), at most 4 parts "
                         f"a side and the conv's own output size; got k {ksize}, stride {stride}, pad "
                         f"{padding}, x {tuple(x_parts[0].shape)}, g {tuple(g_parts[0].shape)}")
    if _grad_dtype(*x_parts, *g_parts) != dtype:
        raise TypeError(f"{form} takes {dtype} parts, got {x_parts[0].dtype}")
    return b, h, w, ho, wo, sum(p.shape[1] for p in x_parts), sum(p.shape[1] for p in g_parts)


def _wgrad_kernel(x_parts, g_parts, ksize, stride, padding):
    kernels.no_graph("wgrad", *x_parts, *g_parts)
    b, h, w, ho, wo, cin, m = _check_wgrad(x_parts, g_parts, ksize, stride, padding, torch.float32,
                                           "K6's CUDA-core form (bf16: wgrad_tc)")
    part = torch.empty((kernels.lib().nct_wgrad_slices(b, ho, wo, m, cin * ksize * ksize), m, cin * ksize * ksize),
                       device=x_parts[0].device)
    out = torch.empty((m, cin, ksize, ksize), device=x_parts[0].device)
    gptrs, gmeta = kernels.part_args(g_parts, [False] * len(g_parts))
    xptrs, xmeta = kernels.part_args(x_parts, [False] * len(x_parts))
    kernels.launch("wgrad", "nct_wgrad", out, gptrs, gmeta, len(g_parts), xptrs, xmeta, len(x_parts),
                   kernels.DTYPE_CODE[torch.float32], b, m, cin, h, w, ho, wo, ksize, stride, padding, part, out)
    return out


def _wgrad_tc_kernel(x_parts, g_parts, ksize, stride, padding):
    kernels.no_graph("wgrad_tc", *x_parts, *g_parts)
    b, h, w, ho, wo, cin, m = _check_wgrad(x_parts, g_parts, ksize, stride, padding, torch.bfloat16,
                                           "K6's tensor-core form")
    part = torch.empty((kernels.lib().nct_wgrad_tc_slices(b, ho, wo, m, cin, ksize), m, cin * ksize * ksize),
                       device=x_parts[0].device)
    out = torch.empty((m, cin, ksize, ksize), device=x_parts[0].device)
    gptrs, gmeta = kernels.part_args(g_parts, [False] * len(g_parts))
    xptrs, xmeta = kernels.part_args(x_parts, [False] * len(x_parts))
    kernels.launch("wgrad_tc", "nct_wgrad_tc", out, gptrs, gmeta, len(g_parts), xptrs, xmeta, len(x_parts),
                   b, m, cin, h, w, ho, wo, ksize, stride, padding, part, out)
    return out
