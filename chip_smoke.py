#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (nconv_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: the card's name and power limit, torch/CUDA versions,
     and the build of the kernels from ``nconv_tpu_torch/csrc``;
  2. every kernel against its plain PyTorch version on the card, at every
     distinct shape the main path launches (KITTI 352x1216, two streams),
     random inputs from seeded generators, with kernel / plain / library
     times from CUDA events (median of 20);
  3. the main path: ``StreamingEngine`` with random-init weights carried
     through BN folding, in f32 and in the mixed schedule, answering
     two-stream requests of synthetic frames; outputs must be finite, zero
     on the sensor border, and match the plain path on the card, both as a
     whole and in their guided residual (output less the step-1 dense
     depth); the mixed output must match the f32 plain path; and every
     kernel must have been launched the expected number of times;
  4. step-1 training: ``Trainer(UnguidedTask(NConvUNet()))`` at full width
     on KITTI 352x1216, batch 4, adamw, on the JAX bench's synthetic batch.
     (a) the backward's kernels (K2's K x K form, K5) against their plain
     versions at every distinct shape of one train step; (b) one train step
     on the kernel path against the plain path, and both against the plain
     path in float64 (the weight cotangent of a normalized conv cancels, so
     its f32 rounding is measured, not assumed); (c) five steps of
     ``Trainer.fit`` on one batch, loss finite and falling; (d) the launch
     counts per train step; (e) train-step p50 / p90 from CUDA events.
  5. guided (step-2) training: ``Trainer(GuidedTask(GuidedDepthNet(),
     step1_state=...))`` at full width on KITTI 352x1216, batch 1, f32,
     adamw 1e-3 / wd 1e-7, train-mode BN, step 1 frozen (the phase-4 model's
     initial state), on the JAX bench's synthetic guided batch. (a) every
     kernel call of one train step against its plain version, at each
     distinct shape (the new forms: K3's 3x3/s2, K2's 4x4/s2 and K6); (b)
     one train step on the kernel path against the plain path, and the
     gradients against the plain path in float64, and the new BN running
     statistics; (c) five steps of ``Trainer.fit`` on one batch, loss finite
     and falling, step 1 bitwise unchanged; (d) the launch counts per train
     step; (e) train-step p50 / p90 from CUDA events.
  6. guided training in the mixed schedule: phase 5's model, state, batch
     and config with ``dtype=torch.bfloat16`` (bf16 feature convs, BN
     elementwise math and ReLU masks; f32 step 1, depth tensors, loss, BN
     statistics and master weights). (a) every kernel call of one bf16 train
     step against its plain version, at each distinct shape (the bf16 forms
     of K2's K x K and 4x4/s2 forms, K3's 3x3/s2 form and K6); (b) one bf16
     step, kernel path against plain path, gradients and the new BN running
     statistics also against phase 5's plain float64 path; (c) five steps
     of ``Trainer.fit``: loss finite and falling, within 2% of phase 5's f32
     fit, step 1 bitwise unchanged, every parameter f32; (d) launch counts
     per step, as phase 5's; (e) train-step p50 / p90 beside phase 5's; (f)
     ``evaluate(make_guided_predict(model), [batch])`` on the fitted bf16
     and f32 models.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line,
and last ``{"ok": true, "device": {...}}``; every checked call's numbers go
to ``build/chip_smoke/chip_smoke_calls.json``. Exits non-zero without a GPU.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

H, W = 352, 1216  # KITTI
N_REQUESTS = 10
REPS = 20
F32_BAR, BF16_BAR = 1e-5, 5e-3  # kernel vs plain, rel RMSE; bf16: output rounding
ENGINE_BAR, MIXED_BAR = 1e-4, 1e-3  # engine kernel vs plain path; mixed vs f32 plain
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
# FLOP/s by the storage type of a call's operands, not of its output: a call
# on bf16 operands could run at the bf16 tensor-core rate (a K6 call on bf16
# parts too, though its output is f32); f32 operands get the f32 CUDA-core
# rate. A u8 frame counts as its weights' type, which the output shares: a u8
# pixel is exact in bf16, and the mixed schedule holds bf16-valued weights.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PER_FRAME = {"nconv": 9, "conv": 23, "conv_transpose": 3, "conv_chain": 4}
# step 1 trains all 9 nconvs; nconv1's input (the sparse depth) needs no
# gradient, so 8 input-gradient convs
PER_TRAIN_STEP = {"nconv": 9, "conv_kxk": 8, "filtergrad": 9}
TRAIN_B, TRAIN_FIT_STEPS, TRAIN_TIMED_STEPS = 4, 5, 20
# guided training, per step: the frozen step 1's fused forward (9 K1); 28
# stride-1 convs and 3 stride-2 encoder pairs (K2), 3 transpose convs (K3);
# backward: 23 stride-1 input gradients (none for the RGB input and the 4
# depth_convs, whose inputs come from the frozen step 1), 3 stride-2 and 3
# transpose-conv input gradients, and 28 + 3 + 3 weight gradients (K6, one
# launch over all parts of a concat). An evaluation (no grad, eval-mode BN)
# runs the unfolded serving forward.
PER_GUIDED_STEP = {"nconv": 9, "conv": 31, "conv_transpose": 3, "conv_kxk": 23,
                   "conv_transpose3x3s2": 3, "conv4x4s2": 3, "wgrad": 34}
PER_GUIDED_EVAL = {"nconv": 9, "conv": 23, "conv_transpose": 3, "conv_chain": 4}
GUIDED_B = 1
STATS_BAR = 1e-5  # BN running statistics after a step, kernel path vs plain path
LOSS_BAR, GRAD_BAR = 1e-6, 1e-4  # train step, kernel path vs plain path
# the same in the mixed schedule, where the two paths may round a bf16
# activation, and so a ReLU mask, differently
BF16_STATS_BAR, BF16_LOSS_BAR, BF16_GRAD_BAR = 1e-3, 1e-4, 1e-3
FIT_RTOL = 0.02  # bf16 fit losses vs the f32 fit's (tests/test_training.py of the JAX package)
# a gradient whose f32 rounding (plain f32 vs plain f64) exceeds GRAD_BAR is
# held to GRAD_NOISE x that rounding instead
GRAD_NOISE = 4.0
KERNELS = {  # name: (source, TPU kernel it replaces)
    "nconv": ("nconv_tpu_torch/csrc/nconv.cu", "nconv_tpu/ops/pallas_nconv_mxu.py:52"),
    "conv": ("nconv_tpu_torch/csrc/conv.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv_transpose": ("nconv_tpu_torch/csrc/convt.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv_chain": ("nconv_tpu_torch/csrc/chain.cu", "nconv_tpu/ops/pallas_chain.py:169"),
    "conv_kxk": ("nconv_tpu_torch/csrc/conv.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "filtergrad": ("nconv_tpu_torch/csrc/filtergrad.cu", "nconv_tpu/ops/pallas_conv.py:1093"),
    "conv_transpose3x3s2": ("nconv_tpu_torch/csrc/convt.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv4x4s2": ("nconv_tpu_torch/csrc/conv.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "wgrad": ("nconv_tpu_torch/csrc/wgrad.cu", "nconv_tpu/ops/pallas_conv.py:1093"),
}
TRAIN_KERNELS = ("conv_kxk", "filtergrad")  # reported per step-1 train step; K1 per frame
GUIDED_KERNELS = ("conv_transpose3x3s2", "conv4x4s2", "wgrad")  # per guided train step
# their bf16 forms, per bf16 guided train step, as entries of their own
BF16_KERNELS = ("conv_kxk", "conv4x4s2", "conv_transpose3x3s2", "wgrad")


def log(*a):
    print(*a, flush=True)


def rel_rmse(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def time_ms(fn, reps=REPS) -> float:
    """Median of ``reps`` single calls, each between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Recording the main path's kernel calls, and replaying them on random inputs
# ---------------------------------------------------------------------------

def _sig(t):
    return None if t is None else (tuple(t.shape), str(t.dtype).replace("torch.", ""),
                                   bool(t.dim() == 4 and t.stride(1) == 1 and t.shape[1] > 1))


class Recorder:
    """Wraps the kernel launchers of ops/ to note each distinct call."""

    def __init__(self):
        self.calls: dict[tuple, int] = {}

    def note(self, key):
        self.calls[key] = self.calls.get(key, 0) + 1

    @contextmanager
    def recording(self):
        from nconv_tpu_torch.ops import convops, nconv

        real = {
            "nc": nconv._nconv2d_kernel, "cv": convops._conv3x3_kernel,
            "ct": convops._conv_transpose_kernel, "ch": convops._chain_kernel,
            "kx": convops._conv_kxk_kernel, "fg": convops._filtergrad_kernel,
            "t3": convops._conv_transpose3x3s2_kernel, "wg": convops._wgrad_kernel,
        }

        def nc(d, c, w, b, padding, up2, crop, pool_out, eps):
            self.note(("nconv", tuple(map(_sig, d)), tuple(up2), _sig(w), padding, crop, pool_out, eps))
            return real["nc"](d, c, w, b, padding, up2, crop, pool_out, eps)

        def cv(parts, w, b, stride, relu, sc, out_dtype):
            self.note(("conv", tuple(map(_sig, parts)), _sig(w), b is not None, stride, relu,
                       _sig(sc), str(out_dtype).replace("torch.", "")))
            return real["cv"](parts, w, b, stride, relu, sc, out_dtype)

        def ct(parts, w, b, relu):
            self.note(("conv_transpose", tuple(map(_sig, parts)), _sig(w), b is not None, relu))
            return real["ct"](parts, w, b, relu)

        def ch(x, w1, b1, w2, b2):
            self.note(("conv_chain", _sig(x), _sig(w1), _sig(w2)))
            return real["ch"](x, w1, b1, w2, b2)

        def kx(x, w, padding, stride):
            self.note(("conv_kxk" if stride == 1 else "conv4x4s2", _sig(x), _sig(w), padding, stride))
            return real["kx"](x, w, padding, stride)

        def fg(x, g, ksize, padding, pad_top):
            self.note(("filtergrad", _sig(x), _sig(g), ksize, padding, pad_top))
            return real["fg"](x, g, ksize, padding, pad_top)

        def t3(x, w):
            self.note(("conv_transpose3x3s2", _sig(x), _sig(w)))
            return real["t3"](x, w)

        def wg(xs, gs, ksize, stride, padding):
            self.note(("wgrad", tuple(map(_sig, xs)), tuple(map(_sig, gs)), ksize, stride, padding))
            return real["wg"](xs, gs, ksize, stride, padding)

        with mock.patch.object(nconv, "_nconv2d_kernel", nc), \
                mock.patch.object(convops, "_conv3x3_kernel", cv), \
                mock.patch.object(convops, "_conv_transpose_kernel", ct), \
                mock.patch.object(convops, "_chain_kernel", ch), \
                mock.patch.object(convops, "_conv_kxk_kernel", kx), \
                mock.patch.object(convops, "_filtergrad_kernel", fg), \
                mock.patch.object(convops, "_conv_transpose3x3s2_kernel", t3), \
                mock.patch.object(convops, "_wgrad_kernel", wg):
            yield


def _rand(sig, g, *, positive=False, scale=1.0):
    import torch

    shape, dtype, channels_last = sig
    dt = getattr(torch, dtype)
    if dt == torch.uint8:
        t = torch.randint(0, 256, shape, generator=g, device="cuda", dtype=torch.uint8)
    elif positive:
        t = torch.rand(shape, generator=g, device="cuda").to(dt)
    else:
        t = (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)
    if channels_last:  # a (B, H, W, C) frame read as NCHW
        t = t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    return t


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _held_at(dtype, *ts):
    """Weights as the main path holds them: f32 tensors at ``dtype``'s values."""
    import torch

    return [None if t is None else t.to(getattr(torch, dtype)).float() for t in ts]


def check_call(key, g):
    """Kernel vs plain (and the library yardstick) on random inputs shaped
    like one recorded main-path call. Returns a result dict."""
    import torch
    import torch.nn.functional as F

    from nconv_tpu_torch.ops import convops, nconv

    kind = key[0]
    library = None
    if kind == "nconv":
        _, dsigs, up2, wsig, padding, crop, pool_out, eps = key
        d = [_rand(s, g, positive=True) * 10 for s in dsigs]
        c = [(_rand(s, g, positive=True) < 0.3).float() for s in dsigs]
        w = _rand(wsig, g, positive=True)
        b = torch.randn(wsig[0][0], generator=g, device="cuda")
        args = dict(padding=padding, up2=list(up2), crop=crop, pool_out=pool_out, eps=eps)
        kern = lambda: nconv._nconv2d_kernel(d, c, w, b, padding, list(up2), crop, pool_out, eps)
        plain = lambda: nconv.nconv2d_fused_plain(d, c, w, b, **args)
        out_dt = in_dt = "float32"
        macs_per_out = 2 * wsig[0][1] * wsig[0][2] * wsig[0][3]
        inputs = d + c + [w, b]
    elif kind == "conv":
        _, psigs, wsig, has_b, stride, relu, scsig, out_dt = key
        parts = [_rand(s, g) for s in psigs]
        fan = wsig[0][1] * 9
        w = _rand(wsig, g, scale=fan ** -0.5)
        b = _rand(((wsig[0][0],), wsig[1], False), g) if has_b else None
        sc = _rand(scsig, g, scale=wsig[0][1] ** -0.5) if scsig else None
        w, b, sc = _held_at(out_dt, w, b, sc)
        od = getattr(torch, out_dt)
        kern = lambda: convops._conv3x3_kernel(parts, w, b, stride, relu, sc, od)
        plain = lambda: convops.conv3x3_plain(parts, w, b, stride=stride, relu=relu, shortcut=sc, out_dtype=od)
        lib_dt = od
        xl = torch.cat([p.to(lib_dt) for p in parts], 1).contiguous()
        wl, bl = w.to(lib_dt), None if b is None else b.to(lib_dt)
        library = lambda: F.conv2d(xl, wl, bl, stride=stride, padding=1)
        macs_per_out = wsig[0][1] * 9 + (wsig[0][1] if sc is not None else 0)
        inputs = parts + [w, b, sc]
        in_dt = out_dt if psigs[0][1] == "uint8" else psigs[0][1]
    elif kind == "conv_transpose":
        _, psigs, wsig, has_b, relu = key
        parts = [_rand(s, g) for s in psigs]
        out_dt = psigs[0][1]
        w = _rand(wsig, g, scale=(16 * wsig[0][0]) ** -0.5)
        b = _rand(((wsig[0][1],), wsig[1], False), g) if has_b else None
        w, b = _held_at(out_dt, w, b)
        kern = lambda: convops._conv_transpose_kernel(parts, w, b, relu)
        plain = lambda: convops.conv_transpose4x4s2_plain(parts, w, b, relu=relu)
        xl = torch.cat(parts, 1).contiguous()
        wl, bl = w.to(xl.dtype), None if b is None else b.to(xl.dtype)
        library = lambda: F.conv_transpose2d(xl, wl, bl, stride=2, padding=1)
        macs_per_out = wsig[0][0] * 4
        inputs = parts + [w, b]
        in_dt = out_dt
    elif kind in ("conv_kxk", "conv4x4s2"):
        _, xsig, wsig, padding, stride = key
        x = _rand(xsig, g)
        cout, cin, k, _ = wsig[0]
        w = _rand(wsig, g, scale=(cin * k * k) ** -0.5)
        kern = lambda: convops._conv_kxk_kernel(x, w, padding, stride)
        plain = lambda: convops.conv2d(x.float(), w.float(), stride=stride, padding=padding).to(x.dtype)
        if stride == 1:
            # the same function as the input cotangent of the forward conv whose
            # flipped, in/out-transposed kernel w is: one library call
            w_fwd = w.flip(2, 3).transpose(0, 1)
            out_shape = (x.shape[0], cout, x.shape[2] + 2 * padding - k + 1, x.shape[3] + 2 * padding - k + 1)
            library = lambda: torch.nn.grad.conv2d_input(out_shape, w_fwd, x, padding=k - 1 - padding)
        else:
            library = lambda: F.conv2d(x, w, stride=stride, padding=padding)
        out_dt = in_dt = xsig[1]
        macs_per_out = cin * k * k
        inputs = [x, w]
    elif kind == "conv_transpose3x3s2":
        _, xsig, wsig = key
        x = _rand(xsig, g)
        cin = wsig[0][0]
        w = _rand(wsig, g, scale=(9 * cin) ** -0.5)
        kern = lambda: convops._conv_transpose3x3s2_kernel(x, w)
        plain = lambda: convops.conv3x3s2_input_grad_plain(x, w)
        library = lambda: F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)
        out_dt = in_dt = xsig[1]
        macs_per_out = cin * 9 / 4  # each input pixel's 9 taps feed a 2x2 output quad
        inputs = [x, w]
    elif kind == "wgrad":
        _, xsigs, gsigs, k, stride, padding = key
        xs, gs = [_rand(s, g) for s in xsigs], [_rand(s, g) for s in gsigs]
        kern = lambda: convops._wgrad_kernel(xs, gs, k, stride, padding)
        plain = lambda: convops.conv2d_weight_grad_plain(xs, gs, k, padding, stride=stride)
        xl, gl = torch.cat(xs, 1), torch.cat(gs, 1)
        w_shape = (gl.shape[1], xl.shape[1], k, k)
        library = lambda: torch.nn.grad.conv2d_weight(xl, w_shape, gl, stride=stride, padding=padding)
        out_dt, in_dt = "float32", xsigs[0][1]
        b_, _, ho, wo = gl.shape
        macs_per_out = b_ * ho * wo  # each weight-cotangent entry sums B*Ho*Wo products
        inputs = xs + gs
    elif kind == "filtergrad":
        _, xsig, gsig, k, padding, pad_top = key
        x, gr = _rand(xsig, g), _rand(gsig, g)
        kern = lambda: convops._filtergrad_kernel(x, gr, k, padding, pad_top)
        plain = lambda: convops.conv2d_weight_grad_plain(x, gr, k, padding, pad_top)
        symmetric = pad_top == padding == gsig[0][2] - xsig[0][2] - padding + k - 1
        w_shape = (gsig[0][1], xsig[0][1], k, k)
        library = (lambda: torch.nn.grad.conv2d_weight(x, w_shape, gr, padding=padding)) if symmetric else None
        out_dt = in_dt = "float32"
        b_, _, ho, wo = gsig[0]
        macs_per_out = b_ * ho * wo  # each weight-cotangent entry sums B*Ho*Wo products
        inputs = [x, gr]
    else:
        _, xsig, w1sig, w2sig = key
        out_dt = in_dt = xsig[1]
        x = _rand(xsig, g)
        w1 = _rand(w1sig, g, scale=(9 * w1sig[0][1]) ** -0.5)
        w2 = _rand(w2sig, g, scale=(9 * w2sig[0][1]) ** -0.5)
        b1 = _rand(((w1sig[0][0],), w1sig[1], False), g)
        b2 = _rand(((w2sig[0][0],), w2sig[1], False), g)
        w1, b1, w2, b2 = _held_at(out_dt, w1, b1, w2, b2)
        kern = lambda: convops._chain_kernel(x, w1, b1, w2, b2)
        plain = lambda: convops.conv3x3_chain2_plain(x, w1, b1, w2, b2)
        cin, cmid, cout = w1sig[0][1], w1sig[0][0], w2sig[0][0]
        macs_per_out = 9 * (cmid * cin + cout * cmid) / cout
        inputs = [x, w1, b1, w2, b2]

    k_out, p_out = kern(), plain()
    torch.cuda.synchronize()
    k_out = k_out if isinstance(k_out, tuple) else (k_out,)
    p_out = p_out if isinstance(p_out, tuple) else (p_out,)
    err = max(rel_rmse(a.float(), b_.float()) for a, b_ in zip(k_out, p_out))
    abs_err = max(float((a.float() - b_.float()).abs().max()) for a, b_ in zip(k_out, p_out))
    bar = F32_BAR if out_dt == "float32" else BF16_BAR
    out_elems = k_out[0].numel()
    flops = 2 * macs_per_out * out_elems
    nbytes = _nbytes(*inputs, *k_out)
    t_ops = flops / PEAK_OPS[in_dt] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(
        kind=kind, err=err, abs_err=abs_err, bar=bar, out_dtype=out_dt, in_dtype=in_dt,
        shape=[list(t.shape) for t in k_out[:1]],
        ms=time_ms(kern), plain_ms=time_ms(plain),
        library_ms=time_ms(library) if library else None,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
    )


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def synthetic_frames(n, seed=0):
    """Smooth depth (meters) under a 5% Bernoulli mask and a smooth u8 RGB
    frame with noise, per stream."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for i in range(n):
        f = []
        for s in range(2):
            ph = rng.random() * 6.28
            depth = 5 + 40 * (yy / H) + 5 * np.sin(xx / 97.0 + ph) * np.cos(yy / 53.0)
            sparse = (depth * (rng.random((H, W)) < 0.05)).astype(np.float32)
            base = np.stack([xx / W, yy / H, 0.5 + 0.5 * np.sin(xx / 40.0 + ph)], -1) * 200
            rgb = np.clip(base + rng.normal(0, 20, (H, W, 3)), 0, 255).astype(np.uint8)
            f += [rgb, sparse]
        frames.append(tuple(f))
    return frames


def random_state(seed=0):
    """Unfolded random-init weights with non-trivial BN statistics."""
    import torch

    from nconv_tpu_torch.models import GuidedDepthNet

    model = GuidedDepthNet(device="cuda", seed=seed)
    g = torch.Generator().manual_seed(seed + 7)
    sd = model.state_dict()
    for k in sd:
        if k.endswith(".bn.running_mean"):
            sd[k] = (torch.randn(sd[k].shape, generator=g) * 0.1).cuda()
        elif k.endswith(".bn.running_var"):
            sd[k] = (0.5 + torch.rand(sd[k].shape, generator=g)).cuda()
        elif k.endswith(".bn.weight"):
            sd[k] = (0.5 + torch.rand(sd[k].shape, generator=g)).cuda()
        elif k.endswith(".bn.bias"):
            sd[k] = (torch.randn(sd[k].shape, generator=g) * 0.1).cuda()
    return sd


def step1_dense(eng, frame):
    """The step-1 dense depth of both streams of ``frame``, (2, H, W, 1) f32."""
    import torch

    depth = torch.cat([eng._decode_depth(eng._stage(d, 1)) for d in (frame[1], frame[3])])
    return eng.model.step1(depth)[0].reshape(2, H, W, 1).float()


def readings(eng, frame, outs):
    """(both streams' output, its guided residual): the residual is the
    output less the step-1 dense depth inside the sensor border, the part
    the RGB-guided (bf16 in the mixed schedule) branch computes."""
    import torch

    out = torch.cat(outs).float()
    return out, (out - step1_dense(eng, frame))[:, 45:H - 45, 20:]


@contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain version for a reference run
    on the card (a substitution made by this script only)."""
    from nconv_tpu_torch import kernels

    with mock.patch.object(kernels, "on_card", lambda *t: False):
        yield


# ---------------------------------------------------------------------------
# Step-1 training
# ---------------------------------------------------------------------------

def step_grads(batch, dtype, cfg, *, plain):
    """Loss and parameter gradients of one train step of a seeded step-1
    model on the card, in ``dtype``, on the kernel path or the plain path."""
    import torch

    from nconv_tpu_torch.models import NConvUNet
    from nconv_tpu_torch.training import UnguidedTask

    model = NConvUNet(device="cuda", seed=0).to(dtype)
    b = {k: v.to(dtype) for k, v in batch.items()}
    with plain_versions() if plain else contextlib.nullcontext():
        loss = UnguidedTask(model).loss(b, cfg=cfg)
        loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.double() for n, p in model.named_parameters()}


def check_all(calls, g, label):
    """``check_call`` on every recorded call; raises if any kernel disagrees
    with its plain version. Returns {key: result}."""
    results, failures = {}, []
    for key, count in calls.items():
        res = check_call(key, g)
        res["count"] = count
        results[key] = res
        ok = res["err"] <= res["bar"]
        log(f"[{'ok' if ok else 'FAIL'}] {key[0]:<19} {label} out {res['shape'][0]} x{count} "
            f"rel_rmse {res['err']:.2e} (bar {res['bar']:.0e}) max_abs {res['abs_err']:.2e} "
            f"ms {res['ms']:.4f} plain {res['plain_ms']:.4f} "
            f"lib {res['library_ms'] if res['library_ms'] is None else round(res['library_ms'], 4)} "
            f"bound {res['bound_ms']:.4f} ({res['bound_by']})")
        if not ok:
            failures.append((key, res["err"]))
    if failures:
        raise SystemExit(f"chip_smoke: {label} kernels disagree with their plain versions: {failures}")
    return results


def step_sums(calls, results, kinds):
    """Per kernel kind: the sum over one step's calls of each time."""
    sums = {}
    for kname in kinds:
        mine = [(k, v) for k, v in results.items() if k[0] == kname]
        sums[kname] = {f: sum(v[f] * calls[k] for k, v in mine) for f in ("ms", "plain_ms", "bound_ms")}
        libs = [v["library_ms"] for _, v in mine]
        sums[kname]["library_ms"] = None if None in libs else sum(v["library_ms"] * calls[k] for k, v in mine)
    log("per train step: " + "; ".join(
        f"{k} ms {v['ms']:.4f} plain {v['plain_ms']:.4f} lib {v['library_ms']} bound {v['bound_ms']:.4f}"
        for k, v in sums.items()))
    return sums


def grad_checks(loss_k, grads_k, loss_p, grads_p, loss_64, grads_64, label, *,
                loss_bar=LOSS_BAR, grad_bar=GRAD_BAR):
    """Kernel path vs plain path: the loss within ``loss_bar`` and each
    gradient within max(``grad_bar``, GRAD_NOISE x the plain path's own error
    against the plain f64 path). Raises on a miss; returns the per-gradient
    numbers."""
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    checks, missed = {}, []
    for name in grads_p:
        vs_plain = rel_rmse(grads_k[name], grads_p[name])
        rounding = rel_rmse(grads_p[name], grads_64[name])  # the plain path's own error
        bar = max(grad_bar, GRAD_NOISE * rounding)
        checks[name] = dict(vs_plain=vs_plain, kernel_vs_f64=rel_rmse(grads_k[name], grads_64[name]),
                            plain_vs_f64=rounding, bar=bar)
        if vs_plain > bar:
            missed.append((name, vs_plain, bar))
    log(f"[{'FAIL' if missed or loss_err > loss_bar else 'ok'}] {label} train step kernel vs plain: "
        f"loss {loss_k:.6f} rel {loss_err:.2e} (bar {loss_bar:.0e}; f64 loss {loss_64:.6f})")
    for name, c in checks.items():
        log(f"    grad {name:<36} vs plain {c['vs_plain']:.2e} (bar {c['bar']:.1e})  "
            f"kernel vs f64 {c['kernel_vs_f64']:.2e}  plain vs f64 {c['plain_vs_f64']:.2e}")
    if loss_err > loss_bar or missed:
        raise SystemExit(f"chip_smoke: {label} train step kernel path vs plain path: loss {loss_err:.2e}, "
                         f"grads {missed}")
    return loss_err, checks


def timed_steps(trainer, batch, per_step, label):
    """(d) and (e): TRAIN_TIMED_STEPS train steps on the kernel path, then on
    the plain path, each between CUDA events; the kernel path must launch
    ``per_step`` per step. Returns {path: {p50_ms, p90_ms}}."""
    import numpy as np
    import torch

    from nconv_tpu_torch import kernels

    times = {}
    for path in ("kernel", "plain"):
        with plain_versions() if path == "plain" else contextlib.nullcontext():
            for _ in range(3):
                trainer.train_step(batch)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            ts = []
            for _ in range(TRAIN_TIMED_STEPS):
                s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s_.record()
                trainer.train_step(batch)
                e_.record()
                e_.synchronize()
                ts.append(s_.elapsed_time(e_))
            counts = kernels.launch_counts()
        times[path] = dict(p50_ms=float(np.percentile(ts, 50)), p90_ms=float(np.percentile(ts, 90)))
        if path == "kernel" and any(counts[k] != v * TRAIN_TIMED_STEPS for k, v in per_step.items()):
            raise SystemExit(f"chip_smoke: {label}: {TRAIN_TIMED_STEPS} train steps launched {counts}, "
                             f"expected {per_step} each")
    log(f"[ok] {label} train step: p50 {times['kernel']['p50_ms']:.3f} ms "
        f"p90 {times['kernel']['p90_ms']:.3f} ms; plain path p50 {times['plain']['p50_ms']:.3f} ms "
        f"p90 {times['plain']['p90_ms']:.3f} ms; launches per step {per_step}")
    return times


def train_phase(g):
    """Phase 4; returns (per-call results, distinct calls of one train step
    with their counts, launch counts of the fit, summary)."""
    import numpy as np
    import torch

    from nconv_tpu_torch import kernels
    from nconv_tpu_torch.data import bench_batch
    from nconv_tpu_torch.models import NConvUNet
    from nconv_tpu_torch.training import OptimizerConfig, TrainConfig, Trainer, UnguidedTask

    batch_np = bench_batch(TRAIN_B, H, W)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    cfg = TrainConfig(epochs=TRAIN_FIT_STEPS, batch_size=TRAIN_B, log_every=0,
                      optimizer=OptimizerConfig("adamw", 1e-3, 1e-7))

    # (a) every kernel call of one train step, at each distinct shape
    r = Recorder()
    with r.recording():
        step_grads(batch, torch.float32, cfg, plain=False)
    results = check_all(r.calls, g, "train")
    sums = step_sums(r.calls, results, PER_TRAIN_STEP)

    # (b) one train step: kernel path and plain path in f32, plain path in f64
    loss_k, grads_k = step_grads(batch, torch.float32, cfg, plain=False)
    loss_p, grads_p = step_grads(batch, torch.float32, cfg, plain=True)
    loss_64, grads_64 = step_grads(batch, torch.float64, cfg, plain=True)
    loss_err, checks = grad_checks(loss_k, grads_k, loss_p, grads_p, loss_64, grads_64, "step-1")

    # (c) five adamw steps through Trainer.fit on the one batch
    trainer = Trainer(UnguidedTask(NConvUNet(device="cuda", seed=0)), cfg, log_fn=lambda m: None)
    kernels.reset_launch_counts()
    fit = trainer.fit(lambda: [batch_np], lambda: [batch_np])
    torch.cuda.synchronize()
    fit_counts = kernels.launch_counts()
    losses = fit.history["train_loss"] + fit.history["val_loss"][-1:]
    want = {k: v * TRAIN_FIT_STEPS for k, v in PER_TRAIN_STEP.items()}
    want["nconv"] += PER_TRAIN_STEP["nconv"] * TRAIN_FIT_STEPS  # one eval per epoch
    falling = bool(np.all(np.isfinite(losses)) and losses[-1] < losses[0])
    log(f"[{'ok' if falling else 'FAIL'}] Trainer.fit {TRAIN_FIT_STEPS} adamw steps, B={TRAIN_B} {H}x{W}: "
        f"losses {[round(v, 6) for v in losses]}; launches {fit_counts}")
    if not falling:
        raise SystemExit(f"chip_smoke: training loss did not fall: {losses}")
    if any(fit_counts[k] != v for k, v in want.items()):
        raise SystemExit(f"chip_smoke: Trainer.fit launched {fit_counts}, expected {want}")

    # (d) launches per train step and (e) its time, kernel path then plain path
    times = timed_steps(trainer, batch, PER_TRAIN_STEP, f"step-1 (B={TRAIN_B}, {H}x{W}, f32, adamw)")
    per_step = {k: c for k, c in r.calls.items() if k[0] in TRAIN_KERNELS}
    summary = dict(loss=loss_k, loss_rel_err=loss_err, loss_f64=loss_64, grads=checks,
                   fit_losses=losses, fit_counts=fit_counts, step_ms=times, kernel_sums_per_step=sums)
    return results, per_step, fit_counts, summary


# ---------------------------------------------------------------------------
# Guided (step-2) training
# ---------------------------------------------------------------------------

def guided_step(batch, dtype, cfg, state, step1_state, *, plain):
    """Loss, trainable gradients and new BN running statistics of one guided
    train step from ``state`` on the card, in the compute ``dtype``, on the
    kernel path or the plain path. Master weights and the batch are f32
    (f64 for the f64 reference)."""
    import torch

    from nconv_tpu_torch.models import GuidedDepthNet
    from nconv_tpu_torch.training import GuidedTask

    wide = torch.float64 if dtype == torch.float64 else torch.float32
    model = GuidedDepthNet(device="cuda", dtype=dtype).to(wide)
    model.load_state_dict(state)
    task = GuidedTask(model.train(), step1_state=step1_state)
    b = {k: v.to(wide) for k, v in batch.items()}
    with plain_versions() if plain else contextlib.nullcontext():
        loss = task.loss(b, cfg=cfg)
        loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.double() for n, p in model.named_parameters() if p.requires_grad}
    return loss.item(), grads, {n: t.double() for n, t in model.named_buffers()}


def guided_phase(g, dtype, f32=None):
    """Phase 5 (``dtype`` f32) or, given phase 5's ``carry`` as ``f32``,
    phase 6 (bf16). Returns (per-call results, distinct calls of one train
    step with their counts, launch counts of the fit, summary, carry: the
    f64 reference step, the fit's losses and metrics, the step times)."""
    import numpy as np
    import torch

    from nconv_tpu_torch import kernels
    from nconv_tpu_torch.data import bench_batch
    from nconv_tpu_torch.models import GuidedDepthNet, NConvUNet
    from nconv_tpu_torch.training import (
        GuidedTask, OptimizerConfig, TrainConfig, Trainer, evaluate, make_guided_predict,
    )

    bf16 = dtype == torch.bfloat16
    label = "guided bf16" if bf16 else "guided"
    batch_np = bench_batch(GUIDED_B, H, W)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    cfg = TrainConfig(epochs=TRAIN_FIT_STEPS, batch_size=GUIDED_B, log_every=0,
                      optimizer=OptimizerConfig("adamw", 1e-3, 1e-7))
    step1_state = NConvUNet(device="cuda", seed=0).state_dict()  # phase 4's initial state
    state = GuidedDepthNet(device="cuda", seed=0).state_dict()

    # (a) every kernel call of one train step, at each distinct shape
    r = Recorder()
    with r.recording():
        guided_step(batch, dtype, cfg, state, step1_state, plain=False)
    results = check_all(r.calls, g, label)
    sums = step_sums(r.calls, results, PER_GUIDED_STEP)

    # (b) one train step: kernel path and plain path in ``dtype``, and the
    # plain path in f64 (phase 5's, which does not depend on ``dtype``)
    loss_k, grads_k, stats_k = guided_step(batch, dtype, cfg, state, step1_state, plain=False)
    loss_p, grads_p, stats_p = guided_step(batch, dtype, cfg, state, step1_state, plain=True)
    if f32 is None:
        ref64 = guided_step(batch, torch.float64, cfg, state, step1_state, plain=True)
    else:
        ref64 = f32["ref64"]
    loss_64, grads_64, stats_64 = ref64
    loss_bar, grad_bar, stats_bar = (BF16_LOSS_BAR, BF16_GRAD_BAR, BF16_STATS_BAR) if bf16 else (
        LOSS_BAR, GRAD_BAR, STATS_BAR)
    loss_err, checks = grad_checks(loss_k, grads_k, loss_p, grads_p, loss_64, grads_64, label,
                                   loss_bar=loss_bar, grad_bar=grad_bar)
    stats_err = {n: rel_rmse(stats_k[n], stats_p[n]) for n in stats_p if not n.startswith("step1.")}
    stats_vs_64 = {n: rel_rmse(stats_k[n], stats_64[n]) for n in stats_err}
    worst = max(stats_err, key=stats_err.get)
    log(f"[{'ok' if stats_err[worst] <= stats_bar else 'FAIL'}] {label} BN running statistics kernel vs plain: "
        f"worst {worst} {stats_err[worst]:.2e} (bar {stats_bar:.0e}); kernel vs f64 worst "
        f"{max(stats_vs_64.values()):.2e}")
    if stats_err[worst] > stats_bar:
        raise SystemExit(f"chip_smoke: {label} running statistics: {worst} {stats_err[worst]:.2e}")

    # (c) five adamw steps through Trainer.fit on the one batch
    model = GuidedDepthNet(device="cuda", dtype=dtype)
    model.load_state_dict(state)
    trainer = Trainer(GuidedTask(model, step1_state=step1_state), cfg, log_fn=lambda m: None)
    kernels.reset_launch_counts()
    fit = trainer.fit(lambda: [batch_np], lambda: [batch_np])
    torch.cuda.synchronize()
    fit_counts = kernels.launch_counts()
    losses = fit.history["train_loss"]
    want = {k: (PER_GUIDED_STEP.get(k, 0) + PER_GUIDED_EVAL.get(k, 0)) * TRAIN_FIT_STEPS for k in kernels.LAUNCHES}
    falling = bool(np.all(np.isfinite(losses + fit.history["val_loss"])) and losses[-1] < losses[0])
    frozen = all(torch.equal(v, model.step1.state_dict()[k]) for k, v in step1_state.items())
    masters = all(p.dtype == torch.float32 for p in model.parameters())
    near_f32 = f32 is None or bool(np.allclose(losses, f32["losses"], rtol=FIT_RTOL, atol=0))
    ok = falling and frozen and masters and near_f32
    log(f"[{'ok' if ok else 'FAIL'}] {label} Trainer.fit {TRAIN_FIT_STEPS} adamw steps, "
        f"B={GUIDED_B} {H}x{W}: train losses {[round(v, 6) for v in losses]}, val losses "
        f"{[round(v, 6) for v in fit.history['val_loss']]}; step 1 bitwise unchanged {frozen}; "
        f"parameters f32 {masters}"
        + ("" if f32 is None else f"; f32 fit {[round(v, 6) for v in f32['losses']]}, within "
           f"{FIT_RTOL:.0%} {near_f32}")
        + f"; launches {fit_counts}")
    if not ok:
        raise SystemExit(f"chip_smoke: {label} training: losses {losses}, step 1 unchanged {frozen}, "
                         f"parameters f32 {masters}, within {FIT_RTOL:.0%} of f32 {near_f32}")
    if fit_counts != want:
        raise SystemExit(f"chip_smoke: {label} Trainer.fit launched {fit_counts}, expected {want}")
    # (f) the metric set of the fitted model on the batch (phase 6 prints both)
    metrics = evaluate(make_guided_predict(model), [batch_np])
    if not (all(np.isfinite(v) for v in metrics.values())
            and 0 <= metrics["delta1"] <= metrics["delta2"] <= metrics["delta3"] <= 1):
        raise SystemExit(f"chip_smoke: {label}: metrics of the fitted model {metrics}")
    if f32 is not None:
        for tag, m in (("bf16", metrics), ("f32", f32["metrics"])):
            log(f"[ok] evaluate(make_guided_predict) of the fitted {tag} model: "
                + ", ".join(f"{k} {v:.6f}" for k, v in m.items()))

    # (d) launches per train step and (e) its time, kernel path then plain path
    name = "bf16" if bf16 else "f32"
    times = timed_steps(trainer, batch, PER_GUIDED_STEP, f"{label} (B={GUIDED_B}, {H}x{W}, {name}, adamw)")
    if f32 is not None:
        log(f"    {label} step p50 / p90 {times['kernel']['p50_ms']:.3f} / {times['kernel']['p90_ms']:.3f} ms "
            f"beside the f32 step's {f32['step_ms']['kernel']['p50_ms']:.3f} / "
            f"{f32['step_ms']['kernel']['p90_ms']:.3f} ms (this run)")
    per_step = {k: c for k, c in r.calls.items() if k[0] in (BF16_KERNELS if bf16 else GUIDED_KERNELS)}
    summary = dict(loss=loss_k, loss_rel_err=loss_err, loss_f64=loss_64, grads=checks, stats=stats_err,
                   stats_vs_f64=stats_vs_64, fit_losses=losses, fit_val_losses=fit.history["val_loss"],
                   fit_counts=fit_counts, step_ms=times, kernel_sums_per_step=sums, metrics=metrics)
    carry = dict(ref64=ref64, losses=losses, step_ms=times, metrics=metrics)
    return results, per_step, fit_counts, summary, carry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # full f32 in every plain version and library yardstick (no TF32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from nconv_tpu_torch import kernels
        from nconv_tpu_torch.runtime import StreamingEngine, benchmark
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    # -- 1. environment and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.lib()
    log(f"kernel build+load {time.perf_counter() - t0:.1f} s (nvcc {kernels.build_seconds or 0:.1f} s)")

    state = random_state()
    frames = synthetic_frames(N_REQUESTS)
    engines = {
        "f32": StreamingEngine(state, height=H, width=W, compute_dtype=torch.float32),
        "mixed": StreamingEngine(state, height=H, width=W, compute_dtype=torch.bfloat16),
    }

    # -- 2. per-kernel checks at the main path's shapes
    rec = {}
    for name, eng in engines.items():
        r = Recorder()
        with r.recording():
            eng(*frames[0])
        torch.cuda.synchronize()
        rec[name] = r.calls
    g = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    failures = []
    for name in ("f32", "mixed"):
        for key, count in rec[name].items():
            if key in results:
                continue
            res = check_call(key, g)
            res["count"] = count
            res["engine"] = name
            results[key] = res
            ok = res["err"] <= res["bar"]
            log(f"[{'ok' if ok else 'FAIL'}] {key[0]:<15} {name:<5} out {res['shape'][0]} {res['out_dtype']:<8} "
                f"x{count} rel_rmse {res['err']:.2e} (bar {res['bar']:.0e}) max_abs {res['abs_err']:.2e} "
                f"ms {res['ms']:.4f} plain {res['plain_ms']:.4f} "
                f"lib {res['library_ms'] if res['library_ms'] is None else round(res['library_ms'], 4)} "
                f"bound {res['bound_ms']:.4f} ({res['bound_by']})")
            if not ok:
                failures.append((key, res["err"]))
    if failures:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failures}")

    # -- 3. the main path: two-stream requests through StreamingEngine
    with torch.no_grad():
        with plain_versions():
            ref = {n: [readings(e, f, e(*f)) for f in frames[:2]] for n, e in engines.items()}
        summary = {}
        for name in ("f32", "mixed"):
            eng = engines[name]
            eng.warmup()
            kernels.reset_launch_counts()
            outs = [eng(*f) for f in frames]
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if name == "mixed":
                main_counts = counts
            for k, per in PER_FRAME.items():
                if counts[k] != per * N_REQUESTS:
                    raise SystemExit(f"chip_smoke: {name}: {k} launched {counts[k]} times, "
                                     f"expected {per} x {N_REQUESTS}")
            for o0, o1 in outs:
                for o in (o0, o1):
                    if o.shape != (1, H, W, 1) or not torch.isfinite(o).all():
                        raise SystemExit(f"chip_smoke: {name}: bad output {tuple(o.shape)}")
                    if o[:, :45].abs().max() != 0 or o[:, H - 45:].abs().max() != 0 or o[:, :, :20].abs().max() != 0:
                        raise SystemExit(f"chip_smoke: {name}: sensor border is not zero")
            got = [readings(eng, frames[i], outs[i]) for i in range(2)]
            err = lambda r, j: max(rel_rmse(got[i][j], r[i][j]) for i in range(2))
            # kernel path vs plain path: the output, and its guided residual
            # (bf16 output rounding in the mixed schedule); mixed vs f32 plain
            checks = {"kernel_vs_plain": (err(ref[name], 0), ENGINE_BAR),
                      "residual_kernel_vs_plain": (err(ref[name], 1), ENGINE_BAR if name == "f32" else BF16_BAR)}
            if name == "mixed":
                checks["vs_f32_plain"] = (err(ref["f32"], 0), MIXED_BAR)
            stats = benchmark(eng, n_frames=N_REQUESTS * 2, warmup=2, frame_factory=lambda i: frames[i % len(frames)])
            summary[name] = dict(**{k: v for k, (v, _) in checks.items()}, p50_ms=stats.p50_ms,
                                 p90_ms=stats.p90_ms, counts=counts)
            missed = {k: v for k, v in checks.items() if v[0] > v[1]}
            log(f"[{'FAIL' if missed else 'ok'}] engine {name}: {N_REQUESTS} requests, "
                + ", ".join(f"{k} {v:.2e} (bar {b:.0e})" for k, (v, b) in checks.items())
                + f"; p50 {stats.p50_ms:.3f} ms p90 {stats.p90_ms:.3f} ms per two-stream frame "
                f"({stats.clock}); launches {counts}")
            if missed:
                raise SystemExit(f"chip_smoke: engine {name} misses its bars: {missed}")

    # -- 4. step-1 training
    train_results, train_calls, train_counts, train_summary = train_phase(g)

    # -- 5. guided (step-2) training, f32
    guided_results, guided_calls, guided_counts, guided_summary, carry = guided_phase(g, torch.float32)

    # -- 6. guided training in the mixed schedule
    bf16_results, bf16_calls, bf16_counts, bf16_summary, _ = guided_phase(g, torch.bfloat16, carry)

    # -- report: one entry per kernel form; sums per two-stream frame over
    # the mixed main path for the serving kernels, per step-1 train step for
    # K2's K x K form and K5, per guided train step for the guided backward
    # forms, per bf16 guided train step for their bf16 forms (launches: the
    # serving run's, and each fit's)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke_calls.json").write_text(json.dumps(
        {"card": smi, "engines": summary, "training": train_summary, "guided_training": guided_summary,
         "guided_training_bf16": bf16_summary,
         "calls": [{"key": repr(k), **v}
                   for k, v in {**results, **train_results, **guided_results, **bf16_results}.items()]},
        indent=1))
    entries = []
    forms = [(k, None) for k in KERNELS] + [(k, "bf16") for k in BF16_KERNELS]
    for kname, form in forms:
        src, replaces = KERNELS[kname]
        if form:
            per, res, launches = bf16_calls, bf16_results, bf16_counts[kname]
        elif kname in TRAIN_KERNELS:
            per, res, launches = train_calls, train_results, train_counts[kname]
        elif kname in GUIDED_KERNELS:
            per, res, launches = guided_calls, guided_results, guided_counts[kname]
        else:
            per, res, launches = rec["mixed"], results, main_counts[kname]
        calls = [(k, r) for k, r in res.items() if k in per and k[0] == kname]
        tot = lambda f: sum(r[f] * per[k] for k, r in calls)
        libs = [r["library_ms"] for _, r in calls]
        bound = tot("bound_ms")
        ops_share = sum(r["bound_ms"] * per[k] for k, r in calls if r["bound_by"] == "operations")
        entries.append(dict(
            name=kname + ("_bf16" if form else ""), route="cuda", source=src, replaces=replaces,
            dtype="/".join(sorted({r["in_dtype"] for _, r in calls})), launches=launches,
            max_abs_err=max(r["abs_err"] for _, r in calls),
            ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=bound,
            bound_by="operations" if ops_share > bound / 2 else "bytes",
            library_ms=None if any(v is None for v in libs) else tot("library_ms"),
        ))
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
