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
CPU tensors it runs :func:`nconv2d_fused_plain`.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from .. import kernels
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
    out, conf = nconv2d(d.float(), c.float(), weight.float(), bias.float(),
                        padding=padding, pos_fn="identity", eps=eps)
    if crop:
        out = out[:, :, crop:-crop, crop:-crop]
        conf = conf[:, :, crop:-crop, crop:-crop]
    if pool_out:
        return (out, conf, *max_pool_pair(out, conf))
    return out, conf


def _nconv2d_kernel(d_parts, c_parts, weight, bias, padding, up2, crop,
                    pool_out, eps):
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
    lib = kernels.lib()
    dptrs, meta = kernels.part_args(d_parts, up2)
    cptrs, _ = kernels.part_args(c_parts, up2)
    code = lib.nct_nconv(
        dptrs, cptrs, meta, len(d_parts), b, h, w, cin, ho, wo, cout, k,
        padding - crop, float(eps), w32.data_ptr(), b32.data_ptr(),
        ksum.data_ptr(), out.data_ptr(), conf.data_ptr(),
        kernels.ptr(pout), kernels.ptr(pconf), kernels.stream_of(out),
    )
    kernels.check(code, "nconv kernel")
    kernels.LAUNCHES["nconv"] += 1
    if pool_out:
        return out, conf, pout, pconf
    return out, conf


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
