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
# FLOP/s by a call's compute type, which is its output's storage type: in the
# mixed schedule every operand holds bf16 values (weights are rounded to bf16
# once, a u8 pixel is exact in bf16), so the card could run it at the bf16
# tensor-core rate; f32 calls get the f32 CUDA-core rate.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PER_FRAME = {"nconv": 9, "conv": 23, "conv_transpose": 3, "conv_chain": 4}
# step 1 trains all 9 nconvs; nconv1's input (the sparse depth) needs no
# gradient, so 8 input-gradient convs
PER_TRAIN_STEP = {"nconv": 9, "conv_kxk": 8, "filtergrad": 9}
TRAIN_B, TRAIN_FIT_STEPS, TRAIN_TIMED_STEPS = 4, 5, 20
LOSS_BAR, GRAD_BAR = 1e-6, 1e-4  # train step, kernel path vs plain path
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
}
TRAIN_KERNELS = ("conv_kxk", "filtergrad")  # reported per train step; K1 per frame


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

        def kx(x, w, padding):
            self.note(("conv_kxk", _sig(x), _sig(w), padding))
            return real["kx"](x, w, padding)

        def fg(x, g, ksize, padding, pad_top):
            self.note(("filtergrad", _sig(x), _sig(g), ksize, padding, pad_top))
            return real["fg"](x, g, ksize, padding, pad_top)

        with mock.patch.object(nconv, "_nconv2d_kernel", nc), \
                mock.patch.object(convops, "_conv3x3_kernel", cv), \
                mock.patch.object(convops, "_conv_transpose_kernel", ct), \
                mock.patch.object(convops, "_chain_kernel", ch), \
                mock.patch.object(convops, "_conv_kxk_kernel", kx), \
                mock.patch.object(convops, "_filtergrad_kernel", fg):
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
        out_dt = "float32"
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
    elif kind == "conv_kxk":
        _, xsig, wsig, padding = key
        x = _rand(xsig, g)
        cout, cin, k, _ = wsig[0]
        w = _rand(wsig, g, scale=(cin * k * k) ** -0.5)
        kern = lambda: convops._conv_kxk_kernel(x, w, padding)
        plain = lambda: convops.conv2d(x, w, padding=padding)
        # the same function as the input cotangent of the forward conv whose
        # flipped, in/out-transposed kernel w is: one library call
        w_fwd = w.flip(2, 3).transpose(0, 1)
        out_shape = (x.shape[0], cout, x.shape[2] + 2 * padding - k + 1, x.shape[3] + 2 * padding - k + 1)
        library = lambda: torch.nn.grad.conv2d_input(out_shape, w_fwd, x, padding=k - 1 - padding)
        out_dt = "float32"
        macs_per_out = cin * k * k
        inputs = [x, w]
    elif kind == "filtergrad":
        _, xsig, gsig, k, padding, pad_top = key
        x, gr = _rand(xsig, g), _rand(gsig, g)
        kern = lambda: convops._filtergrad_kernel(x, gr, k, padding, pad_top)
        plain = lambda: convops.conv2d_weight_grad_plain(x, gr, k, padding, pad_top)
        symmetric = pad_top == padding == gsig[0][2] - xsig[0][2] - padding + k - 1
        w_shape = (gsig[0][1], xsig[0][1], k, k)
        library = (lambda: torch.nn.grad.conv2d_weight(x, w_shape, gr, padding=padding)) if symmetric else None
        out_dt = "float32"
        b_, _, ho, wo = gsig[0]
        macs_per_out = b_ * ho * wo  # each weight-cotangent entry sums B*Ho*Wo products
        inputs = [x, gr]
    else:
        _, xsig, w1sig, w2sig = key
        out_dt = xsig[1]
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
    t_ops = flops / PEAK_OPS[out_dt] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(
        kind=kind, err=err, abs_err=abs_err, bar=bar, out_dtype=out_dt,
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
    results, failures = {}, []
    for key, count in r.calls.items():
        res = check_call(key, g)
        res["count"] = count
        results[key] = res
        ok = res["err"] <= res["bar"]
        log(f"[{'ok' if ok else 'FAIL'}] {key[0]:<15} train out {res['shape'][0]} x{count} "
            f"rel_rmse {res['err']:.2e} (bar {res['bar']:.0e}) max_abs {res['abs_err']:.2e} "
            f"ms {res['ms']:.4f} plain {res['plain_ms']:.4f} "
            f"lib {res['library_ms'] if res['library_ms'] is None else round(res['library_ms'], 4)} "
            f"bound {res['bound_ms']:.4f} ({res['bound_by']})")
        if not ok:
            failures.append((key, res["err"]))
    if failures:
        raise SystemExit(f"chip_smoke: training kernels disagree with their plain versions: {failures}")
    step_sums = {}
    for kname in PER_TRAIN_STEP:
        calls = [(k, v) for k, v in results.items() if k[0] == kname]
        step_sums[kname] = {f: sum(v[f] * r.calls[k] for k, v in calls) for f in ("ms", "plain_ms", "bound_ms")}
        libs = [v["library_ms"] for _, v in calls]
        step_sums[kname]["library_ms"] = None if None in libs else sum(v["library_ms"] * r.calls[k] for k, v in calls)
    log("per train step: " + "; ".join(
        f"{k} ms {v['ms']:.4f} plain {v['plain_ms']:.4f} lib {v['library_ms']} bound {v['bound_ms']:.4f}"
        for k, v in step_sums.items()))

    # (b) one train step: kernel path and plain path in f32, plain path in f64
    loss_k, grads_k = step_grads(batch, torch.float32, cfg, plain=False)
    loss_p, grads_p = step_grads(batch, torch.float32, cfg, plain=True)
    loss_64, grads_64 = step_grads(batch, torch.float64, cfg, plain=True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    grad_checks, missed = {}, []
    for name in grads_p:
        vs_plain = rel_rmse(grads_k[name], grads_p[name])
        rounding = rel_rmse(grads_p[name], grads_64[name])  # the f32 plain path's own error
        bar = max(GRAD_BAR, GRAD_NOISE * rounding)
        grad_checks[name] = dict(vs_plain=vs_plain, kernel_vs_f64=rel_rmse(grads_k[name], grads_64[name]),
                                 plain_vs_f64=rounding, bar=bar)
        if vs_plain > bar:
            missed.append((name, vs_plain, bar))
    log(f"[{'FAIL' if missed or loss_err > LOSS_BAR else 'ok'}] train step kernel vs plain: loss {loss_k:.6f} "
        f"rel {loss_err:.2e} (bar {LOSS_BAR:.0e}; f64 loss {loss_64:.6f})")
    for name, c in grad_checks.items():
        log(f"    grad {name:<20} vs plain {c['vs_plain']:.2e} (bar {c['bar']:.1e})  "
            f"kernel vs f64 {c['kernel_vs_f64']:.2e}  plain f32 vs f64 {c['plain_vs_f64']:.2e}")
    if loss_err > LOSS_BAR or missed:
        raise SystemExit(f"chip_smoke: train step kernel path vs plain path: loss {loss_err:.2e}, grads {missed}")

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
        if path == "kernel" and any(counts[k] != v * TRAIN_TIMED_STEPS for k, v in PER_TRAIN_STEP.items()):
            raise SystemExit(f"chip_smoke: {TRAIN_TIMED_STEPS} train steps launched {counts}, "
                             f"expected {PER_TRAIN_STEP} each")
    log(f"[ok] train step (B={TRAIN_B}, {H}x{W}, f32, adamw): p50 {times['kernel']['p50_ms']:.3f} ms "
        f"p90 {times['kernel']['p90_ms']:.3f} ms; plain path p50 {times['plain']['p50_ms']:.3f} ms "
        f"p90 {times['plain']['p90_ms']:.3f} ms; launches per step {PER_TRAIN_STEP}")
    per_step = {k: c for k, c in r.calls.items() if k[0] in TRAIN_KERNELS}
    summary = dict(loss=loss_k, loss_rel_err=loss_err, loss_f64=loss_64, grads=grad_checks,
                   fit_losses=losses, fit_counts=fit_counts, step_ms=times, kernel_sums_per_step=step_sums)
    return results, per_step, fit_counts, summary


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

    # -- report: one entry per kernel; sums per two-stream frame over the
    # mixed main path for the serving kernels, per train step for the
    # training kernels (launches: the serving run's, and the fit's)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke_calls.json").write_text(json.dumps(
        {"card": smi, "engines": summary, "training": train_summary,
         "calls": [{"key": repr(k), **v} for k, v in {**results, **train_results}.items()]}, indent=1))
    entries = []
    for kname, (src, replaces) in KERNELS.items():
        if kname in TRAIN_KERNELS:
            per, res, launches = train_calls, train_results, train_counts[kname]
        else:
            per, res, launches = rec["mixed"], results, main_counts[kname]
        calls = [(k, r) for k, r in res.items() if k in per and k[0] == kname]
        tot = lambda f: sum(r[f] * per[k] for k, r in calls)
        libs = [r["library_ms"] for _, r in calls]
        bound = tot("bound_ms")
        ops_share = sum(r["bound_ms"] * per[k] for k, r in calls if r["bound_by"] == "operations")
        entries.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=launches,
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
