"""Plain reference of the step-1 densifier and of its training step.

The densifier (Eldesokey et al., arXiv:1811.01791, "step 1" of
lllllcf/Realtime-Depth-Estimation-Nconv) is a 3-level encoder-decoder of
nine normalized convolutions, each carrying a confidence:

    w     = softplus(10 k) / 10           (the kernel made positive)
    nom   = conv(d * c, w),  den = conv(c, w)
    out   = nom / (den + 1e-7) + b,  c_out = den / sum(w)   (per output channel)

with 2x2 max pools of signal and confidence each on its own, nearest 2x
upsamples and channel concats on the way up, nconv6 at pad 0 and nconv7
(1x1) at pad 2, its output cropped by one pixel a side. The confidence
seed is ``depth > 0.01``.

The training step is the reference's ``train_step1.py``: the masked loss
0.8 sqrt(MSE) + 0.2 (mean |Sobel_x| + mean |Sobel_y|) of (gt - pred), then
AdamW (decoupled weight decay, bias-corrected moments) written out here.

Weights are read from a state dict by name (``nconv1.weight``, ...),
optionally under a prefix. Imports torch only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import precision

EPS = 1e-7
CONF_THRESHOLD = 0.01
# (name, padding) in the order the forward uses them
LAYERS = (("nconv1", 2), ("nconv2", 2), ("nconv_down1", 2), ("nconv_down2", 2), ("nconv_down3", 2),
          ("nconv4", 1), ("nconv5", 1), ("nconv6", 0), ("nconv7", 2))
PADS = dict(LAYERS)
LEAVES = tuple(f"{name}.{kind}" for name, _ in LAYERS for kind in ("weight", "bias"))


def positive(k: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(10.0 * k, torch.zeros_like(k)) / 10.0


def nconv(d, c, k, b, pad, *, store, conv):
    w = store(positive(k))
    nom = conv(d * c, w, padding=pad)
    den = conv(c, w, padding=pad)
    out = nom / (den + EPS) + b.view(1, -1, 1, 1)
    return store(out), store(den / w.sum((1, 2, 3)).view(1, -1, 1, 1))


def pool(x: torch.Tensor) -> torch.Tensor:
    """2x2/s2 max (floor mode) as the maximum of strided halves, rows then
    columns: a tie shares its gradient equally, as ``jnp.maximum`` does."""
    x = x[..., : x.shape[-2] // 2 * 2, : x.shape[-1] // 2 * 2]
    x = torch.maximum(x[..., 0::2, :], x[..., 1::2, :])
    return torch.maximum(x[..., 0::2], x[..., 1::2])


def up(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=tuple(like.shape[-2:]), mode="nearest")


def forward(state, depth: torch.Tensor, *, prefix: str = "", store="f32", conv="f32") -> torch.Tensor:
    """Dense depth (B, 1, H, W) of sparse depth (B, 1, H, W); ``store`` and
    ``conv`` name the precision of :mod:`.precision` (``"f32"``: the
    configuration's)."""
    st, cv = precision.STORE[store], precision.CONV[conv]
    h, w = depth.shape[-2:]

    def layer(name, d, c):
        return nconv(d, c, state[f"{prefix}{name}.weight"], state[f"{prefix}{name}.bias"], PADS[name],
                     store=st, conv=cv)

    x0 = depth.float()
    c0 = (x0 > CONF_THRESHOLD).float()
    x1, c1 = layer("nconv1", x0, c0)
    x1, c1 = layer("nconv2", x1, c1)
    x2, c2 = layer("nconv_down1", pool(x1), pool(c1))
    x3, c3 = layer("nconv_down2", pool(x2), pool(c2))
    x4, c4 = layer("nconv_down3", pool(x3), pool(c3))
    x34, c34 = layer("nconv4", torch.cat([x3, up(x4, x3)], 1), torch.cat([c3, up(c4, c3)], 1))
    x23, c23 = layer("nconv5", torch.cat([x2, up(x34, x2)], 1), torch.cat([c2, up(c34, c2)], 1))
    xo, co = layer("nconv6", torch.cat([up(x23, x1), x1], 1), torch.cat([up(c23, c1), c1], 1))
    xo, _ = layer("nconv7", xo, co)
    return xo[:, :, 1:h + 1, 1:w + 1]


def _taps(x: torch.Tensor, axis: int, a: float, b: float, c: float) -> torch.Tensor:
    n = x.shape[axis]
    pad = [0, 0] * (x.ndim - 1 - axis) + [1, 1]
    xp = F.pad(x, pad)
    return a * xp.narrow(axis, 0, n) + b * xp.narrow(axis, 1, n) + c * xp.narrow(axis, 2, n)


def loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The masked depth loss of NCHW ``pred`` and ``gt``."""
    masked = torch.where(gt == 0, torch.zeros_like(pred), pred)
    mse = ((masked - gt) ** 2).mean()
    diff = gt - masked
    gx = _taps(_taps(diff, 3, 1.0, 0.0, -1.0), 2, 1.0, 2.0, 1.0)
    gy = _taps(_taps(diff, 2, 1.0, 0.0, -1.0), 3, 1.0, 2.0, 1.0)
    return 0.8 * torch.sqrt(mse) + 0.2 * (gx.abs().mean() + gy.abs().mean())


def train(state, batches, optimizer: dict, *, conv="f32", fault=None):
    """``len(batches)`` AdamW steps from ``state`` (leaf name -> tensor) on
    ``batches`` (each ``{"depth", "gt"}`` as NHWC tensors on the device).

    Returns ``(losses, first_grads, params)``: each step's loss before its
    update, the first step's gradient of every leaf, and the leaves after
    the last step. ``fault`` plants one the check has to catch:
    ``"half_batch"`` takes each loss over the first half of the batch,
    ``"altered"`` scales each loss by 1.01."""
    names = LEAVES
    params = {n: state[n].detach().clone().float().requires_grad_(True) for n in names}
    lr, wd = optimizer["lr"], optimizer["weight_decay"]
    b1, b2 = optimizer["betas"]
    eps = optimizer["eps"]
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for t, batch in enumerate(batches, 1):
        depth, gt = batch["depth"].permute(0, 3, 1, 2), batch["gt"].permute(0, 3, 1, 2)
        if fault == "half_batch":
            depth, gt = depth[: depth.shape[0] // 2], gt[: gt.shape[0] // 2]
        value = loss(forward(params, depth, conv=conv), gt) * (1.01 if fault == "altered" else 1.0)
        grads = torch.autograd.grad(value, [params[n] for n in names])
        losses.append(float(value.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = params[n]
                p.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
    return losses, first, {n: p.detach() for n, p in params.items()}
