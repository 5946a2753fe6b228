"""Normalized convolution (NCHW, OIHW kernels).

    w      = pos(kernel)                       # non-negative kernel
    denom  = conv(conf, w)
    nomin  = conv(data * conf, w)
    out    = nomin / (denom + eps) + bias
    c_out  = denom / sum_{cin,kh,kw} w         # per output channel, no eps

:func:`nconv2d` is the plain form. :func:`nconv2d_fused` is the fused
layer op of the step-1 network: data and confidence given as parts (a
logical channel concat), a part may be a half-resolution source read as a
2x nearest upsample, an output crop, and the 2x2 max-pooled pair emitted
alongside. On CUDA tensors it launches kernel K1 (``csrc/nconv.cu``); on
CPU tensors it runs :func:`nconv2d_fused_plain`. K1 records no autograd
graph.

:func:`nconv2d_trainable` is the training form: single full-resolution
tensors through an autograd Function whose forward is the fused op (K1 on
the card) and whose backward is the JAX package's hand-written one, on the
input-gradient conv (K2's K x K form) and the filter-grad kernel (K5).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from .. import kernels
from .convops import conv2d_input_grad, conv2d_weight_grad
from .pool import max_pool_pair
from .resize import resize_nearest

EPS_DEFAULT = 1e-7


def _softplus10(w: torch.Tensor) -> torch.Tensor:
    # log(1 + exp(10 w)) / 10 without torch's linear threshold region
    return torch.logaddexp(10.0 * w, torch.zeros_like(w)) / 10.0


def _softmax_per_pair(w: torch.Tensor) -> torch.Tensor:
    # softmax over the kh*kw taps of each (cout, cin) pair
    co, ci = w.shape[:2]
    return torch.softmax(w.reshape(co, ci, -1), dim=-1).reshape(w.shape)


POS_FNS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "softplus": _softplus10,
    "exp": torch.exp,
    "sigmoid": torch.sigmoid,
    "softmax": _softmax_per_pair,
    "identity": lambda w: w,
}


def nconv2d(
    data: torch.Tensor,
    conf: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
    pos_fn: str = "softplus",
    eps: float = EPS_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain normalized convolution; returns ``(out, conf_out)``."""
    w = POS_FNS[pos_fn](kernel)
    with kernels.exact_f32(data):
        nomin = F.conv2d(data * conf, w, stride=stride, padding=padding)
        denom = F.conv2d(conf, w, stride=stride, padding=padding)
    out = nomin / (denom + eps)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1).to(out.dtype)
    conf_out = denom / w.sum(dim=(1, 2, 3)).view(1, -1, 1, 1)
    return out, conf_out


def _check_parts(d_parts, c_parts, up2):
    if not (len(d_parts) == len(c_parts) == len(up2)) or not d_parts:
        raise ValueError("data, conf and up2 need one entry per part")
    if all(up2):
        raise ValueError("at least one part must be at full resolution")
    full = next(p for p, u in zip(d_parts, up2) if not u)
    b, _, h, w = full.shape
    for d, c, u in zip(d_parts, c_parts, up2):
        if d.shape != c.shape:
            raise ValueError(f"data/conf part shapes differ: {d.shape} {c.shape}")
        want = (b, (h + 1) // 2, (w + 1) // 2) if u else (b, h, w)
        if (d.shape[0], d.shape[2], d.shape[3]) != want:
            raise ValueError(f"part {tuple(d.shape)} does not fit {tuple(full.shape)}")
    return b, h, w


def nconv2d_fused(
    d_parts: Sequence[torch.Tensor],
    c_parts: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    padding: int,
    up2: Sequence[bool] | None = None,
    crop: int = 0,
    pool_out: bool = False,
    eps: float = EPS_DEFAULT,
):
    """Fused normalized conv over a logical channel concat of parts.

    ``weight`` (cout, cin, k, k) is the already-positive kernel. Part ``i``
    with ``up2[i]`` holds a half-resolution source that enters as its 2x
    nearest upsample. ``crop`` drops that many pixels from every side of
    the output. Returns ``(out, conf)``, plus ``(pooled_out, pooled_conf)``
    (2x2/s2 max, floor mode, each pooled on its own) with ``pool_out``.
    """
    d_parts, c_parts = list(d_parts), list(c_parts)
    up2 = list(up2) if up2 is not None else [False] * len(d_parts)
    _check_parts(d_parts, c_parts, up2)
    if torch.compiler.is_exporting():
        from . import library
        return library.nconv2d_fused(d_parts, c_parts, weight, bias, padding=padding, up2=up2,
                                     crop=crop, pool_out=pool_out, eps=eps)
    if not kernels.on_card(*d_parts, *c_parts, weight, bias):
        return nconv2d_fused_plain(
            d_parts, c_parts, weight, bias, padding=padding, up2=up2,
            crop=crop, pool_out=pool_out, eps=eps,
        )
    return _nconv2d_kernel(d_parts, c_parts, weight, bias, padding, up2,
                           crop, pool_out, eps)


def nconv2d_fused_plain(
    d_parts, c_parts, weight, bias, *, padding, up2, crop=0, pool_out=False,
    eps=EPS_DEFAULT,
):
    """The plain PyTorch version of :func:`nconv2d_fused` (same signature)."""
    full = next(p for p, u in zip(d_parts, up2) if not u)
    size = tuple(full.shape[2:])
    d = torch.cat([resize_nearest(p, size) if u else p for p, u in zip(d_parts, up2)], 1)
    c = torch.cat([resize_nearest(p, size) if u else p for p, u in zip(c_parts, up2)], 1)
    d, c, weight, bias = map(kernels.widen, (d, c, weight, bias))
    out, conf = nconv2d(d, c, weight, bias, padding=padding, pos_fn="identity", eps=eps)
    if crop:
        out = out[:, :, crop:-crop, crop:-crop]
        conf = conf[:, :, crop:-crop, crop:-crop]
    if pool_out:
        return (out, conf, *max_pool_pair(out, conf))
    return out, conf


def _nconv2d_kernel(d_parts, c_parts, weight, bias, padding, up2, crop,
                    pool_out, eps):
    kernels.no_graph("nconv", *d_parts, *c_parts, weight, bias)
    b, h, w = _check_parts(d_parts, c_parts, up2)
    cout, cin, k, k2 = weight.shape
    for p, u in zip(d_parts + c_parts, up2 + up2):
        if p.dtype != torch.float32:
            raise TypeError(f"K1 takes float32 parts, got {p.dtype}")
        if u and (2 * p.shape[2], 2 * p.shape[3]) != (h, w):
            raise ValueError("K1 upsampled parts need an exact 2x size")
    if k != k2 or k not in (1, 3, 5) or cout not in (1, 8):
        raise ValueError(f"K1 supports k in (1, 3, 5), cout in (1, 8); got {tuple(weight.shape)}")
    if sum(p.shape[1] for p in d_parts) != cin or len(d_parts) > 2:
        raise ValueError("K1 takes at most 2 parts whose channels sum to cin")
    for dp, cp in zip(d_parts, c_parts):
        if any(sd != sc and n > 1 for sd, sc, n in zip(dp.stride(), cp.stride(), dp.shape)):
            raise ValueError("K1 data and conf parts must share strides")
    ho = h + 2 * padding - k + 1 - 2 * crop
    wo = w + 2 * padding - k + 1 - 2 * crop
    if ho <= 0 or wo <= 0:
        raise ValueError("K1 output would be empty")
    w32 = weight.detach().float().contiguous()
    b32 = bias.detach().float().contiguous()
    ksum = w32.sum(dim=(1, 2, 3)).contiguous()
    dev = d_parts[0].device
    out = torch.empty((b, cout, ho, wo), device=dev)
    conf = torch.empty_like(out)
    pout = pconf = None
    if pool_out:
        pout = torch.empty((b, cout, ho // 2, wo // 2), device=dev)
        pconf = torch.empty_like(pout)
    dptrs, meta = kernels.part_args(d_parts, up2)
    cptrs, _ = kernels.part_args(c_parts, up2)
    kernels.launch("nconv", "nct_nconv", out, dptrs, cptrs, meta, len(d_parts), b, h, w, cin, ho, wo, cout, k,
                   padding - crop, float(eps), w32, b32, ksum, out, conf, pout, pconf)
    if pool_out:
        return out, conf, pout, pconf
    return out, conf


class _NConvFunction(torch.autograd.Function):
    """Normalized conv whose backward ports ``_nconv_bhcw_bwd``
    (nconv_tpu/ops/pallas_nconv_mxu.py): it rebuilds ``denom`` and ``nomin``
    from the saved outputs instead of rerunning the forward, takes the data
    and confidence cotangents from one input-gradient conv of the
    batch-stacked ``[d_nomin; d_denom]``, and the weight cotangent from one
    filter-grad of ``[data * conf; conf]`` against it, plus the term of
    ``conf_out = denom / sum(w)`` through ``sum(w)``. The elementwise terms
    and the bias sum are plain torch ops."""

    @staticmethod
    def forward(ctx, data, conf, w, bias, padding, eps):
        out, conf_out = nconv2d_fused([data], [conf], w, bias, padding=padding, eps=eps)
        ctx.padding, ctx.eps = padding, eps
        ctx.save_for_backward(data, conf, w, bias, out, conf_out)
        return out, conf_out

    @staticmethod
    def backward(ctx, g_out, g_conf):
        data, conf, w, bias, out, conf_out = ctx.saved_tensors
        p, eps, n = ctx.padding, ctx.eps, data.shape[0]
        ksum = w.sum(dim=(1, 2, 3))
        kcol = ksum.view(1, -1, 1, 1)
        denom = conf_out * kcol
        nomin = (out - bias.view(1, -1, 1, 1)) * (denom + eps)
        d_nomin = g_out / (denom + eps)
        d_denom = -g_out * nomin / (denom + eps) ** 2 + g_conf / kcol
        cot = torch.cat([d_nomin, d_denom], 0)
        d_data = d_conf = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:  # not for the sparse input
            d_stacked = conv2d_input_grad(cot, w, p)
            d_dc, d_c_denom = d_stacked[:n], d_stacked[n:]
            d_data = d_dc * conf
            d_conf = d_dc * data + d_c_denom
        d_w = conv2d_weight_grad(torch.cat([data * conf, conf], 0), cot, w.shape[-1], p)
        d_ksum = -(g_conf * conf_out).sum(dim=(0, 2, 3)) / ksum
        d_w = d_w + d_ksum.view(-1, 1, 1, 1)
        return d_data, d_conf, d_w, g_out.sum(dim=(0, 2, 3)), None, None


def nconv2d_trainable(
    data: torch.Tensor,
    conf: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    padding: int,
    eps: float = EPS_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable normalized conv, stride 1, of single full-resolution
    f32 tensors (no parts, upsample, crop or pool). ``weight`` is the
    already-positive kernel, so autograd carries the ``pos_fn`` VJP."""
    return _NConvFunction.apply(data, conf, weight, bias, padding, eps)


# ---------------------------------------------------------------------------
# Initializers (OIHW shapes, explicit generators)
# ---------------------------------------------------------------------------

def poisson_kernel_pmf(ksize: int) -> torch.Tensor:
    """Separable Poisson-pmf kernel w[i, j] = pmf(i; mu) * pmf(j; mu), mu = k/2."""
    mu = ksize / 2
    pmf = torch.tensor(
        [math.exp(-mu) * mu**i / math.factorial(i) for i in range(ksize)],
        dtype=torch.float64,
    )
    return torch.outer(pmf, pmf).float()


def poisson_init(shape, generator: torch.Generator) -> torch.Tensor:
    """Poisson-pmf base + U[0, 1) noise, shape (cout, cin, kh, kw)."""
    return poisson_kernel_pmf(shape[2]) + torch.rand(shape, generator=generator)


def kaiming_uniform_init(shape, generator: torch.Generator) -> torch.Tensor:
    """torch ``kaiming_uniform_`` defaults (gain sqrt(2)), fan_in mode."""
    fan_in = shape[1] * shape[2] * shape[3]
    bound = math.sqrt(2.0) * math.sqrt(3.0 / fan_in)
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def xavier_uniform_init(shape, generator: torch.Generator) -> torch.Tensor:
    fan_in = shape[1] * shape[2] * shape[3]
    fan_out = shape[0] * shape[2] * shape[3]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


INIT_FNS = {"p": poisson_init, "k": kaiming_uniform_init, "x": xavier_uniform_init}
