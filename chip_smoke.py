#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (nconv_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: the card's name and power limit, torch/CUDA versions,
     the build of the kernels from ``nconv_tpu_torch/csrc`` and of the
     host library from ``csrc/host``;
  2. every kernel against its plain PyTorch version on the card, at every
     distinct shape the main path launches (KITTI 352x1216, two streams;
     in the mixed schedule the bf16 convs and transpose convs run on the
     tensor-core forms ``conv_tc`` / ``conv_transpose_tc``, the u8 frame's
     encoder and the depth heads on ``conv_thin``, the conv chains on
     ``conv_chain_tc``), random inputs from seeded generators, with kernel /
     plain / library times from CUDA events (median of 20); beside each bf16
     chain, two cuDNN bf16 convs and two ``conv_tc`` launches on the same
     shapes, beside each f32 chain two cuDNN f32 convs and two launches of
     K2's f32 forward (``conv``);
  3. the main path: ``StreamingEngine`` with random-init weights carried
     through BN folding, in f32 and in the mixed schedule, answering
     two-stream requests of synthetic frames, each a replay of the frame's
     CUDA graph. (a) every result bitwise equal to the engine's eager frame
     (``forward_staged``) on the same frame; (b) the capture's launch
     counts one frame's, the counted run's (the engine's eager warm-up
     frames and its capture; a replay launches without Python) that many
     times over, and an eager pass's the same; (c) ten frames, ten
     distinct results; outputs finite, zero on the sensor border, and
     matching the plain path on the card, both as a whole and in their
     guided residual (output less the step-1 dense depth); the mixed
     output matching the f32 plain path; beside those bars, both paths'
     distances from a float64 plain run of the same weights, so that a
     crossing can be told from an error; (d) ``benchmark``'s ``device`` /
     ``synced`` / ``e2e`` p50 / p90 beside the eager request's ``e2e``,
     the busy share and kernel names of graphed requests from
     ``runtime/profile.py``, the engine's peak memory; (e) each of the
     mixed frame's ``conv_tc`` / ``conv_transpose_tc`` / ``conv_chain_tc``
     calls, slowest first: its single-launch ms, its device ms (its
     launches replayed from a CUDA graph, no host time between them),
     bound and share, their sums a frame and the frame's three p50s;
 3b. the wires, mixed: a second build capturing the same launches; the COO
     wire bitwise equal to the dense uint16 wire; yuv422 / yuv420 against
     the dense wire on the JAX tests' natural-content frame (bars 1e-3 /
     5e-3) and on the synthetic frames (5e-3), their new kernel call
     (encoder 0 on ``conv_tc`` at cin 3) against its plain version; the
     yuv420 + COO wire's three clocks; an overflowing COO capacity counted
     and warned; ``run()`` over the frames in order and bitwise equal to
     single calls, with its frames/s (the wire encoders' host times: phase
     9); ``benchmark_throughput`` at batch 8 (B = 16), bf16, with every
     distinct kernel call it makes against its plain version;
  4. step-1 training: ``Trainer(UnguidedTask(NConvUNet()))`` at full width
     on KITTI 352x1216, batch 4, adamw, on the JAX bench's synthetic batch.
     (a) the backward's kernels (K2's K x K form, K5) against their plain
     versions at every distinct shape of one train step, each K x K call
     also with its and its plain version's distance from a float64 run,
     each K5 call also launched twice on the same operands, the two
     results bitwise equal (its fixed summation order); (b) one train step
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
     distinct shape (the new forms: K3's 3x3/s2, K2's 4x4/s2 and K6; each
     K6 and K x K call also with its and its plain version's distance from
     a float64 run, so a new summation order can be told from an error); (b)
     one train step on the kernel path against the plain path, and the
     gradients against the plain path in float64, and the new BN running
     statistics; (c) five steps of ``Trainer.fit`` on one batch, loss finite
     and falling, step 1 bitwise unchanged; (d) the launch counts per train
     step; (e) train-step p50 / p90 from CUDA events.
  6. guided training in the mixed schedule: phase 5's model, state, batch
     and config with ``dtype=torch.bfloat16`` (bf16 feature convs, BN
     elementwise math and ReLU masks; f32 step 1, depth tensors, loss, BN
     statistics and master weights). (a) every kernel call of one bf16 train
     step against its plain version, at each distinct shape (the backward's
     tensor-core forms: the stride-1 input gradient, ``conv_input_grad_tc``,
     the 4x4/s2 one, ``conv4x4s2_tc``, K3's 3x3/s2 form,
     ``conv_transpose3x3s2_tc``, and K6, ``wgrad_tc``; each but the 3x3/s2
     form also prints each call's distance, and its plain version's, from a
     float64 plain run; each also timed from CUDA-graph replays, no host
     wrapper, beside its library call replayed the same way, and summed a
     step per kernel: launches, single-launch ms, device ms, library device
     ms, bound and share of bound on both clocks); (b) one bf16
     step, kernel path against plain path, gradients and the new BN running
     statistics also against phase 5's plain float64 path; (c) five steps
     of ``Trainer.fit``: loss finite and falling, within 2% of phase 5's f32
     fit, step 1 bitwise unchanged, every parameter f32; (d) launch counts
     per step (the forward convs on the tensor-core forms); (e) train-step
     p50 / p90 beside phase 5's; (f) ``evaluate(make_guided_predict(model),
     [batch])`` on the fitted bf16 and f32 models; (g) the residual conv's
     autograd Function at the RGB encoders' shapes, f32 and bf16, kernel
     path against plain path.

  7. the command line, ``nconv_tpu_torch.cli.main`` on the card, everything
     under ``build/chip_smoke/cli``: (a) a NYU-layout tree at 480x640 (8
     train, 2 val frames, ``.npy`` depth, RGB PNGs whose rows cycle through
     the five PNG filters, a pool of 4 masks), one image decoded bitwise,
     the decode time of a 352x1216 RGB PNG; (b) ``train-step1`` over a
     2 x 2 lr x wd grid, 2 epochs at B = 4, one cell after another and
     ``--grid-parallel`` (lockstep): walls, launches (K1, K x K, K5), the
     first cell (the only one whose data stream is the same in both runs)
     within rtol 1e-5; then both grids on the tree's batches decoded
     once, where every cell
     sees the same data: the same winner, every cell's losses within rtol
     1e-5 and lr within 1e-6, the winner's state within rtol 1e-4 / atol
     1e-6, and the walls of serial, lockstep, lockstep, serial; (c) ``train-step2`` from (b)'s best step 1,
     f32 and ``--precision bf16``: finite losses, a launch of every form of
     the guided step; (d) ``eval`` of both models against ``evaluate()``
     called directly (rtol 1e-5); (e) ``infer`` at 352x1216 on 3 PNG pairs,
     f32 and ``--mixed``: every depth PNG bitwise the engine's own output
     after the uint16 rounding, every visualisation an RGB uint8 PNG; (f)
     ``bench``, ``bench --throughput --batch 8``, ``bench --train [--precision
     bf16]`` beside phases 3-6's numbers, and ``profile --mixed``.
  8. export and interop, everything under ``build/chip_smoke/export``: (a)
     phase 3's folded model, f32 and mixed, exported at 352x1216 with a
     dynamic batch on the card (``runtime/export.py``: K1-K4 as the custom
     ops of ``ops/library.py``), saved, reloaded in a fresh process that
     imports only the port; at b = 1 and 2 its outputs bitwise the eager
     ``export``'s on the same f32 inputs and its launches the eager call's
     (every serving family nonzero); p50s (CUDA events) of the program, the
     eager call and phase 3's graph replay, the export, save and reload
     times; (b) the deployment ONNX at 480x640 with its contract checked,
     and a 128x160 artifact run by the port's numpy interpreter at b = 2
     against the card's plain path (1e-4); (c) ``export --selftest``,
     ``export --format onnx --selftest``, ``convert --reverse`` and
     ``convert`` through ``run_cli``, the state converted back equal to the
     one written.
  9. data parallelism and the native host data path: (a) one adamw step
     of step 1 at B = 4 through ``Trainer(mesh=make_mesh())`` on a
     world-size-1 NCCL group, bitwise the plain ``Trainer``; (b) world size
     2 over gloo, two processes (this script with ``--dp-rank``) both on
     cuda:0, each rank's model from another seed: one step of step 1 at B =
     4 (2 + 2) and one of guided f32 at B = 2 (1 + 1, train-mode BN across
     the ranks), the loss and every gradient against one process on the
     whole batch (``grad_checks``: loss rel 1e-6, each gradient within
     max(1e-4, 4x the whole batch's plain f32 path's distance from its
     float64 plain run)); (c)
     ``DataParallelEngine`` on [cuda:0] and [cuda:0, cuda:0], f32 and
     mixed, N = 3 rigs (padded to 4 on two replicas) against a single-rig
     ``export`` of each (rel RMSE 1e-6 / 1e-4, bitwise or not), frames/s at
     N = 8 beside ``benchmark_throughput``'s; (d) the C wire encoders
     against ``runtime/wires.py`` (depth and COO bitwise, YUV within one
     step) with host ms of both, the engines' ``synced`` / ``e2e`` p50
     with the plain and the C encoders in turns, the C PNG reader bitwise
     ``png.py``'s plain unfilter on a 352x1216 file of each row filter
     with ms of both, and the 4-thread / 1-thread read rate (printed, not
     asserted).

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line,
and last ``{"ok": true, "device": {...}}``; every checked call's numbers go
to ``build/chip_smoke/chip_smoke_calls.json``. Exits non-zero without a GPU.
"""
from __future__ import annotations

import contextlib
import copy
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
# per two-stream frame, by schedule: in the mixed one the bf16 convs with 8 or
# more output channels, the transpose convs and the conv chains run on the
# tensor cores, the u8 frame's encoder and the 4 depth heads on the thin
# CUDA-core form
PER_FRAME = {
    "f32": {"nconv": 9, "conv": 23, "conv_transpose": 3, "conv_chain": 4},
    "mixed": {"nconv": 9, "conv_tc": 18, "conv_thin": 5, "conv_transpose_tc": 3, "conv_chain_tc": 4},
}
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
# In the mixed schedule (recorded from a bf16 train step and evaluation):
# the 27 forward convs with 8 or more output channels, the 3 transpose convs
# and an evaluation's 4 chains on the tensor cores, the 4 depth heads on the
# thin form.
# The bf16 step's input gradients and weight gradients run on the tensor
# cores.
PER_GUIDED_STEP = {
    "f32": {"nconv": 9, "conv": 31, "conv_transpose": 3, "conv_kxk": 23,
            "conv_transpose3x3s2": 3, "conv4x4s2": 3, "wgrad": 34},
    "bf16": {"nconv": 9, "conv_tc": 27, "conv_thin": 4, "conv_transpose_tc": 3, "conv_input_grad_tc": 23,
             "conv_transpose3x3s2_tc": 3, "conv4x4s2_tc": 3, "wgrad_tc": 34},
}
PER_GUIDED_EVAL = {
    "f32": {"nconv": 9, "conv": 23, "conv_transpose": 3, "conv_chain": 4},
    "bf16": {"nconv": 9, "conv_tc": 19, "conv_thin": 4, "conv_transpose_tc": 3, "conv_chain_tc": 4},
}
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
    "conv_tc": ("nconv_tpu_torch/csrc/conv_tc.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv_thin": ("nconv_tpu_torch/csrc/conv_thin.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv_transpose": ("nconv_tpu_torch/csrc/convt.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv_transpose_tc": ("nconv_tpu_torch/csrc/conv_tc.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv_chain": ("nconv_tpu_torch/csrc/chain.cu", "nconv_tpu/ops/pallas_chain.py:169"),
    "conv_chain_tc": ("nconv_tpu_torch/csrc/conv_chain_tc.cu", "nconv_tpu/ops/pallas_chain.py:169"),
    "conv_kxk": ("nconv_tpu_torch/csrc/conv.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv_input_grad_tc": ("nconv_tpu_torch/csrc/conv_tc.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "filtergrad": ("nconv_tpu_torch/csrc/filtergrad.cu", "nconv_tpu/ops/pallas_conv.py:1093"),
    "conv_transpose3x3s2": ("nconv_tpu_torch/csrc/convt.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv_transpose3x3s2_tc": ("nconv_tpu_torch/csrc/conv_tc.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv4x4s2": ("nconv_tpu_torch/csrc/conv.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "conv4x4s2_tc": ("nconv_tpu_torch/csrc/conv_tc.cu", "nconv_tpu/ops/pallas_conv.py:128"),
    "wgrad": ("nconv_tpu_torch/csrc/wgrad.cu", "nconv_tpu/ops/pallas_conv.py:1093"),
    "wgrad_tc": ("nconv_tpu_torch/csrc/wgrad_tc.cu", "nconv_tpu/ops/pallas_conv.py:1093"),
}
# timed beside each bf16 chain: two cuDNN bf16 convs, two conv_tc launches;
# beside each f32 chain: two cuDNN f32 convs, two launches of K2's f32 forward
YARDSTICKS = ("two_cudnn_bf16_ms", "two_conv_tc_ms", "two_cudnn_f32_ms", "two_conv_f32_ms")
TRAIN_KERNELS = ("conv_kxk", "filtergrad")  # reported per step-1 train step; K1 per frame
# the mixed frame's tensor-core forms, each call broken down after phase 3
TC_SERVING = ("conv_tc", "conv_transpose_tc", "conv_chain_tc")
GUIDED_KERNELS = ("conv_transpose3x3s2", "conv4x4s2", "wgrad")  # per f32 guided train step
# per bf16 guided train step: the tensor-core backward forms, which only the
# bf16 step runs
BF16_STEP_KERNELS = ("conv_input_grad_tc", "conv4x4s2_tc", "conv_transpose3x3s2_tc", "wgrad_tc")


def log(*a):
    print(*a, flush=True)


def _ms(v):
    return "-" if v is None else f"{v:.4f}"


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


def graph_ms(fn, n=20, reps=5) -> float:
    """Device ms of one call: ``n`` calls captured as one CUDA graph (no host
    time between the launches), the median of ``reps`` replays between two
    CUDA events, over ``n``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    del graph
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
            "nc": nconv._nconv2d_kernel, "cv": convops._conv3x3_kernel, "tc": convops._conv_tc_kernel,
            "th": convops._conv_thin_kernel, "ct": convops._conv_transpose_kernel,
            "tt": convops._conv_transpose_tc_kernel, "ch": convops._chain_kernel, "cc": convops._chain_tc_kernel,
            "kx": convops._conv_kxk_kernel, "fg": convops._filtergrad_kernel,
            "t3": convops._conv_transpose3x3s2_kernel, "wg": convops._wgrad_kernel,
            "t3c": convops._conv_transpose3x3s2_tc_kernel, "wgc": convops._wgrad_tc_kernel,
            "ig": convops._conv_input_grad_tc_kernel, "k4": convops._conv4x4s2_tc_kernel,
        }

        def nc(d, c, w, b, padding, up2, crop, pool_out, eps):
            self.note(("nconv", tuple(map(_sig, d)), tuple(up2), _sig(w), padding, crop, pool_out, eps))
            return real["nc"](d, c, w, b, padding, up2, crop, pool_out, eps)

        def cv(parts, w, b, stride, relu, sc, out_dtype):
            self.note(("conv", tuple(map(_sig, parts)), _sig(w), b is not None, stride, relu,
                       _sig(sc), str(out_dtype).replace("torch.", "")))
            return real["cv"](parts, w, b, stride, relu, sc, out_dtype)

        def tc(parts, w, b, stride, relu, sc):
            self.note(("conv_tc", tuple(map(_sig, parts)), _sig(w), _sig(b), stride, relu, _sig(sc)))
            return real["tc"](parts, w, b, stride, relu, sc)

        def th(parts, w, b, relu, sc):
            self.note(("conv_thin", tuple(map(_sig, parts)), _sig(w), b is not None, relu, _sig(sc)))
            return real["th"](parts, w, b, relu, sc)

        def ct(parts, w, b, relu):
            self.note(("conv_transpose", tuple(map(_sig, parts)), _sig(w), b is not None, relu))
            return real["ct"](parts, w, b, relu)

        def tt(parts, w, b, relu):
            self.note(("conv_transpose_tc", tuple(map(_sig, parts)), _sig(w), _sig(b), relu))
            return real["tt"](parts, w, b, relu)

        def ch(x, w1, b1, w2, b2):
            self.note(("conv_chain", _sig(x), _sig(w1), _sig(w2)))
            return real["ch"](x, w1, b1, w2, b2)

        def cc(x, w1, b1, w2, b2):
            self.note(("conv_chain_tc", _sig(x), _sig(w1), _sig(b1), _sig(w2), _sig(b2)))
            return real["cc"](x, w1, b1, w2, b2)

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

        def t3c(x, w, *centre):  # centre: the trailing channels whose weights are centre-only
            self.note(("conv_transpose3x3s2_tc", _sig(x), _sig(w), centre[0] if centre else 0))
            return real["t3c"](x, w, *centre)

        def wgc(xs, gs, ksize, stride, padding):
            self.note(("wgrad_tc", tuple(map(_sig, xs)), tuple(map(_sig, gs)), ksize, stride, padding))
            return real["wgc"](xs, gs, ksize, stride, padding)

        def ig(cot, w, padding):
            self.note(("conv_input_grad_tc", _sig(cot), _sig(w), padding))
            return real["ig"](cot, w, padding)

        def k4(cot, w):
            self.note(("conv4x4s2_tc", _sig(cot), _sig(w)))
            return real["k4"](cot, w)

        with mock.patch.object(nconv, "_nconv2d_kernel", nc), \
                mock.patch.object(convops, "_conv3x3_kernel", cv), \
                mock.patch.object(convops, "_conv_tc_kernel", tc), \
                mock.patch.object(convops, "_conv_thin_kernel", th), \
                mock.patch.object(convops, "_conv_transpose_kernel", ct), \
                mock.patch.object(convops, "_conv_transpose_tc_kernel", tt), \
                mock.patch.object(convops, "_chain_kernel", ch), \
                mock.patch.object(convops, "_chain_tc_kernel", cc), \
                mock.patch.object(convops, "_conv_kxk_kernel", kx), \
                mock.patch.object(convops, "_filtergrad_kernel", fg), \
                mock.patch.object(convops, "_conv_transpose3x3s2_kernel", t3), \
                mock.patch.object(convops, "_wgrad_kernel", wg), \
                mock.patch.object(convops, "_conv_transpose3x3s2_tc_kernel", t3c), \
                mock.patch.object(convops, "_wgrad_tc_kernel", wgc), \
                mock.patch.object(convops, "_conv_input_grad_tc_kernel", ig), \
                mock.patch.object(convops, "_conv4x4s2_tc_kernel", k4):
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


def _as_recorded(*ts):
    """Weights as a tensor-core call was given them: a bf16 tensor as it is
    (the unfolded bf16 model's per-call cast), an f32 one held at bf16
    values (the folded serving model)."""
    import torch

    return [t if t is None or t.dtype == torch.bfloat16 else t.to(torch.bfloat16).float() for t in ts]


def check_call(key, g):
    """Kernel vs plain (and the library yardstick) on random inputs shaped
    like one recorded main-path call. Returns a result dict."""
    import torch
    import torch.nn.functional as F

    from nconv_tpu_torch.ops import convops, nconv

    kind = key[0]
    library, yardsticks, ref64 = None, {}, None
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
    elif kind == "conv_thin":
        _, psigs, wsig, has_b, relu, scsig = key
        parts = [_rand(s, g) for s in psigs]
        w = _rand(wsig, g, scale=(wsig[0][1] * 9) ** -0.5)
        b = _rand(((wsig[0][0],), wsig[1], False), g) if has_b else None
        sc = _rand(scsig, g, scale=wsig[0][1] ** -0.5) if scsig else None
        w, b, sc = _held_at("bfloat16", w, b, sc)
        kern = lambda: convops._conv_thin_kernel(parts, w, b, relu, sc)
        plain = lambda: convops.conv3x3_plain(parts, w, b, relu=relu, shortcut=sc, out_dtype=torch.bfloat16)
        xl = torch.cat([p.to(torch.bfloat16) for p in parts], 1).contiguous()
        wl, bl = w.to(torch.bfloat16), None if b is None else b.to(torch.bfloat16)
        library = lambda: F.conv2d(xl, wl, bl, padding=1)
        macs_per_out = wsig[0][1] * 9 + (wsig[0][1] if sc is not None else 0)
        inputs = parts + [w, b, sc]
        out_dt = in_dt = "bfloat16"
    elif kind == "conv_tc":
        _, psigs, wsig, bsig, stride, relu, scsig = key
        parts = [_rand(s, g) for s in psigs]
        fan = wsig[0][1] * 9
        w = _rand(wsig, g, scale=fan ** -0.5)
        b = _rand(bsig, g) if bsig else None
        sc = _rand(scsig, g, scale=wsig[0][1] ** -0.5) if scsig else None
        w, b, sc = _as_recorded(w, b, sc)
        kern = lambda: convops._conv_tc_kernel(parts, w, b, stride, relu, sc)
        plain = lambda: convops.conv3x3_plain(parts, w, b, stride=stride, relu=relu, shortcut=sc,
                                              out_dtype=torch.bfloat16)
        xl = torch.cat(parts, 1).contiguous()
        wl, bl = w.to(torch.bfloat16), None if b is None else b.to(torch.bfloat16)
        library = lambda: F.conv2d(xl, wl, bl, stride=stride, padding=1)
        macs_per_out = wsig[0][1] * 9 + (wsig[0][1] if sc is not None else 0)
        inputs = parts + [w, b, sc]
        out_dt = in_dt = "bfloat16"
    elif kind == "conv_transpose_tc":
        _, psigs, wsig, bsig, relu = key
        parts = [_rand(s, g) for s in psigs]
        w = _rand(wsig, g, scale=(16 * wsig[0][0]) ** -0.5)
        b = _rand(bsig, g) if bsig else None
        w, b = _as_recorded(w, b)
        kern = lambda: convops._conv_transpose_tc_kernel(parts, w, b, relu)
        plain = lambda: convops.conv_transpose4x4s2_plain(parts, w, b, relu=relu)
        xl = torch.cat(parts, 1).contiguous()
        wl, bl = w.to(torch.bfloat16), None if b is None else b.to(torch.bfloat16)
        library = lambda: F.conv_transpose2d(xl, wl, bl, stride=2, padding=1)
        macs_per_out = wsig[0][0] * 4
        inputs = parts + [w, b]
        out_dt = in_dt = "bfloat16"
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
        # at stride 1, w is the forward conv's weight (x's channels, cout, k, k)
        cin, k = xsig[0][1], wsig[0][-1]
        cout = wsig[0][1] if stride == 1 else wsig[0][0]
        w = _rand(wsig, g, scale=(cin * k * k) ** -0.5)
        kern = lambda: convops._conv_kxk_kernel(x, w, padding, stride)
        as_kxk = lambda t: t.flip(2, 3).transpose(0, 1) if stride == 1 else t
        plain = lambda: convops.conv2d(x.float(), as_kxk(w).float(), stride=stride, padding=padding).to(x.dtype)
        ref64 = lambda: convops.conv2d(x.double(), as_kxk(w).double(), stride=stride, padding=padding)
        if stride == 1:
            # the input cotangent of the forward conv whose weight w is: one library call
            out_shape = (x.shape[0], cout, x.shape[2] + 2 * padding - k + 1, x.shape[3] + 2 * padding - k + 1)
            library = lambda: torch.nn.grad.conv2d_input(out_shape, w, x, padding=k - 1 - padding)
        else:
            library = lambda: F.conv2d(x, w, stride=stride, padding=padding)
        out_dt = in_dt = xsig[1]
        macs_per_out = cin * k * k
        inputs = [x, w]
    elif kind == "conv_input_grad_tc":
        _, xsig, wsig, padding = key
        x = _rand(xsig, g)
        cout, cin = wsig[0][:2]  # the forward conv's weight: x has its cout channels
        w = _rand(wsig, g, scale=(9 * cin) ** -0.5)
        kern = lambda: convops._conv_input_grad_tc_kernel(x, w, padding)
        plain = lambda: convops.conv2d_input_grad_plain(x, w, padding)
        ref64 = lambda: convops.conv2d_input_grad_plain(x.double(), w.double(), padding)
        out_shape = (x.shape[0], cin, x.shape[2] + 2 - 2 * padding, x.shape[3] + 2 - 2 * padding)
        library = lambda: torch.nn.grad.conv2d_input(out_shape, w, x, padding=padding)
        out_dt = in_dt = xsig[1]
        macs_per_out = cout * 9
        inputs = [x, w]
    elif kind == "conv4x4s2_tc":
        _, xsig, wsig = key
        x = _rand(xsig, g)
        cin_t, cout_t = wsig[0][:2]  # the transpose conv's weight, read as OIHW
        w = _rand(wsig, g, scale=(16 * cout_t) ** -0.5)
        kern = lambda: convops._conv4x4s2_tc_kernel(x, w)
        plain = lambda: convops.conv_transpose4x4s2_input_grad_plain(x, w)
        ref64 = lambda: convops.conv_transpose4x4s2_input_grad_plain(x.double(), w.double())
        library = lambda: F.conv2d(x, w, stride=2, padding=1)
        out_dt = in_dt = xsig[1]
        macs_per_out = cout_t * 16
        inputs = [x, w]
    elif kind in ("conv_transpose3x3s2", "conv_transpose3x3s2_tc"):
        _, xsig, wsig, *rest = key
        centre = rest[0] if rest else 0
        x = _rand(xsig, g)
        cin = wsig[0][0]
        w = _rand(wsig, g, scale=(9 * cin) ** -0.5)
        if centre:  # the residual backward's stacking: the trailing rows a 1x1 kernel at the centre tap
            w[cin - centre:] *= F.pad(torch.ones(1, 1, 1, 1, device="cuda", dtype=w.dtype), (1, 1, 1, 1))
        wrapper = convops._conv_transpose3x3s2_tc_kernel if kind.endswith("_tc") else convops._conv_transpose3x3s2_kernel
        kern = (lambda: wrapper(x, w, centre)) if centre else (lambda: wrapper(x, w))
        plain = lambda: convops.conv3x3s2_input_grad_plain(x, w)
        library = lambda: F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)
        out_dt = in_dt = xsig[1]
        macs_per_out = cin * 9 / 4  # each input pixel's 9 taps feed a 2x2 output quad
        inputs = [x, w]
    elif kind in ("wgrad", "wgrad_tc"):
        _, xsigs, gsigs, k, stride, padding = key
        xs, gs = [_rand(s, g) for s in xsigs], [_rand(s, g) for s in gsigs]
        wrapper = convops._wgrad_tc_kernel if kind == "wgrad_tc" else convops._wgrad_kernel
        kern = lambda: wrapper(xs, gs, k, stride, padding)
        plain = lambda: convops.conv2d_weight_grad_plain(xs, gs, k, padding, stride=stride)
        # the float64 plain run (kernels.widen keeps f64): each path's distance from it
        ref64 = lambda: convops.conv2d_weight_grad_plain([t.double() for t in xs], [t.double() for t in gs], k,
                                                         padding, stride=stride)
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
    elif kind == "conv_chain_tc":
        _, xsig, w1sig, b1sig, w2sig, b2sig = key
        out_dt = in_dt = "bfloat16"
        x = _rand(xsig, g)
        w1 = _rand(w1sig, g, scale=(9 * w1sig[0][1]) ** -0.5)
        w2 = _rand(w2sig, g, scale=(9 * w2sig[0][1]) ** -0.5)
        b1, b2 = _rand(b1sig, g), _rand(b2sig, g)
        w1, b1, w2, b2 = _as_recorded(w1, b1, w2, b2)
        kern = lambda: convops._chain_tc_kernel(x, w1, b1, w2, b2)
        plain = lambda: convops.conv3x3_chain2_plain(x, w1, b1, w2, b2)
        cin, cmid, cout = w1sig[0][1], w1sig[0][0], w2sig[0][0]
        macs_per_out = 9 * (cmid * cin + cout * cmid) / cout
        inputs = [x, w1, b1, w2, b2]
        # the yardsticks: two cuDNN bf16 convs, and two conv_tc launches
        lw1, lb1, lw2, lb2 = (t.to(torch.bfloat16) for t in (w1, b1, w2, b2))
        yardsticks = {
            "two_cudnn_bf16_ms": lambda: torch.relu(F.conv2d(torch.relu(F.conv2d(x, lw1, lb1, padding=1)), lw2, lb2,
                                                               padding=1)),
            "two_conv_tc_ms": lambda: convops._conv_tc_kernel(
                [convops._conv_tc_kernel([x], w1, b1, 1, True, None)], w2, b2, 1, True, None),
        }
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
        # the yardsticks: two cuDNN f32 convs (TF32 off, as main() sets), and
        # two launches of K2's own f32 forward
        yardsticks = {
            "two_cudnn_f32_ms": lambda: torch.relu(F.conv2d(torch.relu(F.conv2d(x, w1, b1, padding=1)), w2, b2,
                                                            padding=1)),
            "two_conv_f32_ms": lambda: convops._conv3x3_kernel(
                [convops._conv3x3_kernel([x], w1, b1, 1, True, None, torch.float32)], w2, b2, 1, True, None,
                torch.float32),
        }

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
    # K5's fixed summation order: a second launch on the same operands is bitwise equal
    repeat = dict(bitwise_repeat=bool(torch.equal(k_out[0], kern()))) if kind == "filtergrad" else {}
    if ref64:
        r64 = ref64()
        yardsticks_f64 = dict(f64_err=rel_rmse(k_out[0], r64), plain_f64_err=rel_rmse(p_out[0], r64))
        del r64
    else:
        yardsticks_f64 = {}
    # every form's device time without the host wrapper, and its library
    # call's on the same clock (graph replays)
    device = dict(device_ms=graph_ms(kern), library_device_ms=graph_ms(library) if library else None)
    return dict(
        kind=kind, err=err, abs_err=abs_err, bar=bar, out_dtype=out_dt, in_dtype=in_dt,
        shape=[list(t.shape) for t in k_out[:1]], **device,
        ms=time_ms(kern), plain_ms=time_ms(plain),
        library_ms=time_ms(library) if library else None,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
        **{k: time_ms(f) for k, f in yardsticks.items()}, **yardsticks_f64, **repeat,
    )


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def tc_breakdown(results, calls, bench):
    """Each tensor-core call of a mixed frame, slowest first: its launches a
    frame, single-launch ms (host wrapper included) and device ms (graph
    replay), bound and share of bound; sums per kernel; the frame's three
    p50 clocks beside them. Returns the sums."""
    mine = sorted(((k, r) for k, r in results.items() if k[0] in TC_SERVING and k in calls),
                  key=lambda kr: -kr[1]["device_ms"] * calls[kr[0]])
    for key, r in mine:
        chans = "+".join(str(sig[0][1]) for sig in key[1]) if key[0] != "conv_chain_tc" else str(key[1][0][1])
        form = (f"s{key[4]}{' res' if key[6] else ''}" if key[0] == "conv_tc" else
                "4x4/s2" if key[0] == "conv_transpose_tc" else f"mid {key[2][0][0]}")
        log(f"    {key[0]:<17} x{calls[key]} in {chans} {form} out {r['shape'][0]}: ms {r['ms']:.4f} "
            f"device {r['device_ms']:.4f} bound {r['bound_ms']:.4f} ({r['bound_by']}) "
            f"share {r['bound_ms'] / r['device_ms']:.1%} of device, {r['bound_ms'] / r['ms']:.1%} of ms")
    sums = {}
    for kname in TC_SERVING:
        rows = [(k, r) for k, r in mine if k[0] == kname]
        sums[kname] = {f: sum(r[f] * calls[k] for k, r in rows) for f in ("ms", "device_ms", "bound_ms")}
    log("per mixed frame: " + "; ".join(
        f"{k} ms {v['ms']:.4f} device {v['device_ms']:.4f} bound {v['bound_ms']:.4f} "
        f"share {v['bound_ms'] / v['device_ms']:.1%}" for k, v in sums.items())
        + "; frame p50 " + ", ".join(f"{k} {v['p50_ms']:.3f} ms" for k, v in bench.items()))
    return sums


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

    inputs = eng.decode(eng.stage(*frame))
    return eng.model.step1(torch.cat([inputs[1], inputs[3]]))[0].reshape(2, H, W, 1).float()


def readings(eng, frame, outs):
    """(both streams' output, its guided residual): the residual is the
    output less the step-1 dense depth inside the sensor border, the part
    the RGB-guided (bf16 in the mixed schedule) branch computes."""
    import torch

    out = torch.cat(outs).float()
    return out, (out - step1_dense(eng, frame))[:, 45:H - 45, 20:]


def readings_f64(eng, frame, model64):
    """``readings`` of ``frame`` through ``model64``, the float64 twin of
    ``eng.model`` (:func:`f64_twin`), on the plain path: the u8 RGB enters
    as its f64 values, which the u8 conv decodes to."""
    import torch

    rgb0, d0, rgb1, d1 = (t.double() for t in eng.decode(eng.stage(*frame)))
    out = torch.cat(model64.export(rgb0, d0, rgb1, d1))
    depth = [d0, d1]
    dense = model64.step1(torch.cat(depth))[0].reshape(2, H, W, 1)
    return out, (out - dense)[:, 45:H - 45, 20:]


def f64_twin(model):
    """``model`` with its weights as held, computing in float64 throughout:
    the reference that tells a kernel path's rounding from an error."""
    import torch

    twin = copy.deepcopy(model).double()
    twin.dtype = torch.float64
    return twin


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
        ok = res["err"] <= res["bar"] and res.get("bitwise_repeat", True)
        log(f"[{'ok' if ok else 'FAIL'}] {key[0]:<19} {label} out {res['shape'][0]} x{count} "
            f"rel_rmse {res['err']:.2e} (bar {res['bar']:.0e}) max_abs {res['abs_err']:.2e} "
            f"ms {res['ms']:.4f} plain {res['plain_ms']:.4f} "
            f"lib {res['library_ms'] if res['library_ms'] is None else round(res['library_ms'], 4)} "
            f"bound {res['bound_ms']:.4f} ({res['bound_by']}) device {res['device_ms']:.4f} "
            f"lib device {_ms(res['library_device_ms'])}"
            + (f" vs f64 {res['f64_err']:.4e} (plain vs f64 {res['plain_f64_err']:.4e})" if "f64_err" in res else "")
            + (f" bitwise repeat {res['bitwise_repeat']}" if "bitwise_repeat" in res else ""))
        if not ok:
            failures.append((key, res["err"], res.get("bitwise_repeat")))
    if failures:
        raise SystemExit(f"chip_smoke: {label} kernels disagree with their plain versions: {failures}")
    return results


def step_sums(calls, results, kinds):
    """Per kernel kind: the launches of one step's calls and the sum over
    them of each time; where every call has a graph-replayed device time
    (the tensor-core forms), that and its library call's, and the share of
    bound on both clocks."""
    sums = {}
    for kname in kinds:
        mine = [(k, v) for k, v in results.items() if k[0] == kname]
        sums[kname] = {f: sum(v[f] * calls[k] for k, v in mine) for f in ("ms", "plain_ms", "bound_ms")}
        sums[kname]["launches"] = sum(calls[k] for k, _ in mine)
        for f in ("library_ms", "device_ms", "library_device_ms"):
            vals = [v.get(f) for _, v in mine]
            sums[kname][f] = None if None in vals else sum(v[f] * calls[k] for k, v in mine)
    for k, v in sums.items():
        if not v["launches"]:
            continue
        line = (f"per train step: {k} x{v['launches']} ms {v['ms']:.4f} plain {v['plain_ms']:.4f} "
                f"lib {v['library_ms']} bound {v['bound_ms']:.4f} share {v['bound_ms'] / v['ms']:.1%} of ms")
        if v["device_ms"] is not None:
            line += (f"; device {v['device_ms']:.4f} lib device {v['library_device_ms']} "
                     f"share {v['bound_ms'] / v['device_ms']:.1%} of device")
        log(line)
    return sums


def grad_checks(loss_k, grads_k, loss_p, grads_p, loss_64, grads_64, label, *,
                loss_bar=LOSS_BAR, grad_bar=GRAD_BAR, plain_grads=None):
    """Kernel path vs plain path: the loss within ``loss_bar`` and each
    gradient within max(``grad_bar``, GRAD_NOISE x the plain path's own error
    against the plain f64 path). ``plain_grads`` gives the plain path's
    gradients where ``grads_p`` is another reference (phase 9: one process
    on the whole batch). Raises on a miss; returns the per-gradient
    numbers."""
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    plain_grads = grads_p if plain_grads is None else plain_grads
    checks, missed = {}, []
    for name in grads_p:
        vs_plain = rel_rmse(grads_k[name], grads_p[name])
        rounding = rel_rmse(plain_grads[name], grads_64[name])  # the plain path's own error
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
        if path == "kernel" and any(counts[k] != per_step.get(k, 0) * TRAIN_TIMED_STEPS for k in counts):
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
    per_step, per_eval = PER_GUIDED_STEP["bf16" if bf16 else "f32"], PER_GUIDED_EVAL["bf16" if bf16 else "f32"]
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
    sums = step_sums(r.calls, results, per_step)

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
    want = {k: (per_step.get(k, 0) + per_eval.get(k, 0)) * TRAIN_FIT_STEPS for k in kernels.LAUNCHES}
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
    times = timed_steps(trainer, batch, per_step, f"{label} (B={GUIDED_B}, {H}x{W}, {name}, adamw)")
    if f32 is not None:
        log(f"    {label} step p50 / p90 {times['kernel']['p50_ms']:.3f} / {times['kernel']['p90_ms']:.3f} ms "
            f"beside the f32 step's {f32['step_ms']['kernel']['p50_ms']:.3f} / "
            f"{f32['step_ms']['kernel']['p90_ms']:.3f} ms (this run)")
    step_calls = {k: c for k, c in r.calls.items() if k[0] in (BF16_STEP_KERNELS if bf16 else GUIDED_KERNELS)}
    summary = dict(loss=loss_k, loss_rel_err=loss_err, loss_f64=loss_64, grads=checks, stats=stats_err,
                   stats_vs_f64=stats_vs_64, fit_losses=losses, fit_val_losses=fit.history["val_loss"],
                   fit_counts=fit_counts, step_ms=times, kernel_sums_per_step=sums, metrics=metrics)
    carry = dict(ref64=ref64, losses=losses, step_ms=times, metrics=metrics)
    return results, step_calls, fit_counts, summary, carry


# ---------------------------------------------------------------------------
# The served frame: the engine's CUDA graph, the wires, run(), throughput
# ---------------------------------------------------------------------------

SCHEDULES = {"f32": "float32", "mixed": "bfloat16"}
# a frame whose RGB reaches the net in the compute dtype (a float32 or YUV
# wire): in the mixed schedule encoder 0 leaves conv_thin for conv_tc
PER_FRAME_FLOAT_RGB = {
    "f32": PER_FRAME["f32"],
    "mixed": {"nconv": 9, "conv_tc": 19, "conv_thin": 4, "conv_transpose_tc": 3, "conv_chain_tc": 4},
}
BENCH_FRAMES = 100  # benchmark(): device 10 windows of 10 frames, synced and e2e 25 each
RUN_PASSES = 3  # run() is timed over the ten frames three times over
COO_SMALL = 4096  # a COO capacity that the synthetic frames' ~21,400 points a stream overflow
# rel RMSE against the dense wire on the JAX package's natural-content frame
# (tests/test_runtime.py); on the noisy synthetic frames every YUV wire is
# held to yuv420's bar
YUV_BARS = {"yuv422": 1e-3, "yuv420": 5e-3}
THROUGHPUT_B = 8  # benchmark_throughput's batch a stream (16 in the net)


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def natural_frame(depth):
    """The smooth, luma-dominant RGB frame of the JAX package's YUV wire
    tests (``tests/test_runtime.py``) at H x W, both streams, with
    ``depth``."""
    import numpy as np

    i, j = np.mgrid[0:H, 0:W].astype(np.float32)
    rgb = np.stack([100 + 50 * np.sin(i / 19), 100 + 50 * np.cos(j / 23), 90 + i / 4], -1).astype(np.float32)
    return rgb, depth, rgb, depth


def percentiles(lat_ms):
    import numpy as np

    return {"p50_ms": float(np.percentile(lat_ms, 50)), "p90_ms": float(np.percentile(lat_ms, 90)),
            "n_frames": len(lat_ms), "clock": "host"}


def eager_e2e(eng, frames, n):
    """The eager request on the same tree, host clock to a synchronize:
    encode, copy (:meth:`stage`) and the eager frame, every kernel launched
    from Python."""
    import torch

    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        eng.forward_staged(eng.stage(*frames[i % len(frames)]))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return percentiles(lat)


def host_ms(fn, reps=REPS) -> float:
    """Median host-clock ms of ``reps`` calls of a host function."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fresh_peak():
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def serve_phase(state, frames, ref, ref64):
    """Phase 3, per schedule: the engine built (eager warm-up frames, then
    the capture) and ``N_REQUESTS`` requests served, each a graph replay,
    with the launch counts of that run; the capture's counts; the graph
    bitwise equal to the eager frame on every request, ten distinct
    results; the bars against the plain path and the f64 run on the first
    two frames; ``benchmark``'s three clocks beside the eager request's;
    the busy share of a request from ``runtime/profile.py``; peak memory.
    Returns (summary, launch counts of each counted run, capture counts)."""
    import itertools

    import torch

    from nconv_tpu_torch import kernels
    from nconv_tpu_torch.runtime import StreamingEngine, benchmark
    from nconv_tpu_torch.runtime.profile import trace

    summary, counted, captured = {}, {}, {}
    for name in ("f32", "mixed"):
        per = PER_FRAME[name]
        fresh_peak()
        # the main path's run: the warm-up frames and the capture launch
        # through the wrappers; a replay launches the captured kernels
        # without Python, so the requests add nothing here
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng = StreamingEngine(state, height=H, width=W, compute_dtype=getattr(torch, SCHEDULES[name]))
        build_s = time.perf_counter() - t0
        outs = [eng(*f) for f in frames]
        torch.cuda.synchronize()
        counts = nonzero(kernels.launch_counts())
        peak = torch.cuda.max_memory_allocated()
        runs = eng.WARM_RUNS + 1
        if eng.capture_counts != per or counts != {k: n * runs for k, n in per.items()}:
            raise SystemExit(f"chip_smoke: {name}: capture launched {eng.capture_counts}, the run {counts}; "
                             f"expected {per} and {runs} x that")
        counted[name], captured[name] = counts, eng.capture_counts
        kernels.reset_launch_counts()
        eager = [eng.forward_staged(eng.stage(*f)) for f in frames]
        torch.cuda.synchronize()
        eager_counts = nonzero(kernels.launch_counts())
        if eager_counts != {k: n * N_REQUESTS for k, n in per.items()}:
            raise SystemExit(f"chip_smoke: {name}: the eager frames launched {eager_counts}")
        bitwise = all(torch.equal(a, b) for o, e in zip(outs, eager) for a, b in zip(o, e))
        distinct = all(not torch.equal(outs[i][s], outs[j][s]) for s in (0, 1)
                       for i in range(N_REQUESTS) for j in range(i))
        if not (bitwise and distinct):
            raise SystemExit(f"chip_smoke: {name}: graph bitwise the eager frame {bitwise}, "
                             f"{N_REQUESTS} distinct results {distinct}")
        del eager
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
        dist = lambda rd, j: max(rel_rmse(rd[i][j], ref64[name][i][j]) for i in range(2))
        f64 = {path: {"output": dist(rd, 0), "residual": dist(rd, 1)}
               for path, rd in (("kernel", got), ("plain", ref[name]))}
        stats = {k: v.as_dict() for k, v in benchmark(
            eng, n_frames=BENCH_FRAMES, warmup=10, frame_factory=lambda i: frames[i % len(frames)]).items()}
        eager_stats = eager_e2e(eng, frames, BENCH_FRAMES // 4)
        cycle = itertools.cycle(frames)
        prof = trace(lambda: eng(*next(cycle)), N_REQUESTS)
        summary[name] = dict(**{k: v for k, (v, _) in checks.items()}, vs_f64=f64, build_s=build_s,
                             peak_bytes=peak, counts=counts, capture_counts=eng.capture_counts,
                             graph_bitwise_eager=bitwise, distinct_results=distinct, benchmark=stats,
                             eager_e2e=eager_stats, profile=prof)
        missed = {k: v for k, v in checks.items() if v[0] > v[1]}
        log(f"[{'FAIL' if missed else 'ok'}] engine {name}: {N_REQUESTS} requests through one CUDA graph, "
            f"bitwise the eager frame on each, {N_REQUESTS} distinct results; "
            + ", ".join(f"{k} {v:.2e} (bar {b:.0e})" for k, (v, b) in checks.items())
            + f"; capture launches {eng.capture_counts}; the run's launches {counts} "
            f"({eng.WARM_RUNS} eager warm-up frames + the capture); build {build_s:.2f} s, "
            f"peak {peak / 2**20:.0f} MiB")
        log(f"    engine {name} distance from the f64 plain run: "
            + "; ".join(f"{path} path output {d['output']:.2e} residual {d['residual']:.2e}"
                        for path, d in f64.items()))
        log(f"    engine {name} ms per two-stream frame: "
            + "; ".join(f"{k} p50 {v['p50_ms']:.3f} p90 {v['p90_ms']:.3f} ({v['clock']})" for k, v in stats.items())
            + f"; eager request e2e p50 {eager_stats['p50_ms']:.3f} p90 {eager_stats['p90_ms']:.3f} (host)")
        busy = prof["device_busy_share"]
        top = list(prof["device_events_per_request"].items())[:6]
        log(f"    engine {name} profile (runtime/profile.py, graphed requests): wall "
            f"{prof['wall_ms_per_request']:.3f} ms, device busy {prof['device_busy_ms_per_request']} ms, "
            f"share {busy}; device events a request {sum(prof['device_events_per_request'].values()):.1f}, "
            f"the largest: " + "; ".join(f"{k[:60]} x{n:g}" for k, n in top))
        if missed:
            raise SystemExit(f"chip_smoke: engine {name} misses its bars: {missed}")
        del eng, outs, got
    return summary, counted, captured


def wire_phase(state, frames, g, results, captured):
    """Phase 3b, mixed schedule: a second build of the dense engine
    captures the same launches; COO bitwise the dense wire; the YUV wires
    against the dense wire (natural content: their bars; synthetic frames:
    yuv420's bar), their conv_tc calls at cin 3 checked; the COO overflow
    counted; ``run()`` in order and bitwise the single calls;
    ``benchmark_throughput`` at batch 8, each of its
    distinct kernel calls checked. Returns (summary, checked calls)."""
    import warnings

    import numpy as np
    import torch

    from nconv_tpu_torch.runtime import StreamingEngine, benchmark, benchmark_throughput

    def built(**kw):
        fresh_peak()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # yuv420's accuracy warning
            eng = StreamingEngine(state, height=H, width=W, compute_dtype=torch.bfloat16, **kw)
        return eng, torch.cuda.max_memory_allocated()

    def check_new(calls, label):
        checked = {}
        for key, count in calls.items():
            if key in results or key in checked:
                continue
            res = check_call(key, g)
            res.update(count=count, engine=label)
            checked[key] = res
            ok = res["err"] <= res["bar"]
            log(f"[{'ok' if ok else 'FAIL'}] {key[0]:<15} {label} out {res['shape'][0]} rel_rmse {res['err']:.2e} "
                f"(bar {res['bar']:.0e}) ms {res['ms']:.4f} plain {res['plain_ms']:.4f} lib "
                f"{res['library_ms'] if res['library_ms'] is None else round(res['library_ms'], 4)} "
                f"bound {res['bound_ms']:.4f} ({res['bound_by']})")
            if not ok:
                raise SystemExit(f"chip_smoke: {label}: {key[0]} disagrees with its plain version")
        return checked

    out, checked = {}, {}
    dense, peak = built()
    if dense.capture_counts != captured["mixed"]:
        raise SystemExit(f"chip_smoke: a second build captured {dense.capture_counts}, the first {captured['mixed']}")
    single = [dense(*f) for f in frames]
    out["dense"] = dict(wire_bytes=dense.wire_bytes_per_frame, peak_bytes=peak, capture_counts=dense.capture_counts)

    coo, peak = built(depth_wire="coo")
    coo_equal = all(torch.equal(a, b) for f, s in zip(frames, single) for a, b in zip(coo(*f), s))
    out["coo"] = dict(wire_bytes=coo.wire_bytes_per_frame, peak_bytes=peak, capture_counts=coo.capture_counts,
                      bitwise_dense=coo_equal, dropped=coo.coo_dropped_points)
    log(f"[{'ok' if coo_equal and not coo.coo_dropped_points else 'FAIL'}] COO wire ({coo.coo_capacity} points, "
        f"{coo.wire_bytes_per_frame} B a frame against {dense.wire_bytes_per_frame}) bitwise the dense wire on "
        f"{N_REQUESTS} frames; capture {coo.capture_counts}, peak {peak / 2**20:.0f} MiB")
    if not coo_equal or coo.coo_dropped_points:
        raise SystemExit("chip_smoke: the COO wire differs from the dense uint16 wire")
    del coo

    natural = natural_frame(frames[0][1])
    nat_ref = torch.cat(dense(*natural))
    for wire in ("yuv422", "yuv420"):
        eng, peak = built(rgb_wire=wire)
        if wire == "yuv422":  # its calls: the frame's with the RGB in bf16 (encoder 0 on conv_tc at cin 3)
            r = Recorder()
            with r.recording():
                eng.forward_staged(eng.stage(*frames[0]))
            checked.update(check_new(r.calls, "yuv422"))
        nat = rel_rmse(torch.cat(eng(*natural)), nat_ref)
        syn = max(rel_rmse(torch.cat(eng(*f)), torch.cat(s)) for f, s in zip(frames, single))
        ok = (eng.capture_counts == PER_FRAME_FLOAT_RGB["mixed"] and nat <= YUV_BARS[wire]
              and syn <= YUV_BARS["yuv420"])
        out[wire] = dict(wire_bytes=eng.wire_bytes_per_frame, peak_bytes=peak, capture_counts=eng.capture_counts,
                         natural=nat, synthetic=syn)
        log(f"[{'ok' if ok else 'FAIL'}] {wire} wire ({eng.wire_bytes_per_frame} B a frame) against the dense "
            f"wire: natural frame {nat:.2e} (bar {YUV_BARS[wire]:.0e}), synthetic frames {syn:.2e} "
            f"(bar {YUV_BARS['yuv420']:.0e}); capture {eng.capture_counts}, peak {peak / 2**20:.0f} MiB")
        if not ok:
            raise SystemExit(f"chip_smoke: the {wire} wire misses its bars")
        del eng

    eng, peak = built(rgb_wire="yuv420", depth_wire="coo")
    stats = {k: v.as_dict() for k, v in benchmark(
        eng, n_frames=BENCH_FRAMES, warmup=10, frame_factory=lambda i: frames[i % len(frames)]).items()}
    out["yuv420_coo"] = dict(wire_bytes=eng.wire_bytes_per_frame, peak_bytes=peak, benchmark=stats)
    log(f"    yuv420 + COO ({eng.wire_bytes_per_frame} B a frame) ms per two-stream frame: "
        + "; ".join(f"{k} p50 {v['p50_ms']:.3f} p90 {v['p90_ms']:.3f} ({v['clock']})" for k, v in stats.items()))
    del eng

    small, _ = built(depth_wire="coo", coo_capacity=COO_SMALL)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        o = small(*frames[0])
    points = [int(np.count_nonzero(frames[0][i])) for i in (1, 3)]
    want = sum(max(0, n - COO_SMALL) for n in points)
    warned = any("COO depth wire capacity" in str(w.message) for w in caught)
    ok = small.coo_dropped_points == want > 0 and warned and all(torch.isfinite(t).all() for t in o)
    out["coo_overflow"] = dict(capacity=COO_SMALL, points=points, dropped=small.coo_dropped_points, warned=warned)
    log(f"[{'ok' if ok else 'FAIL'}] COO overflow: capacity {COO_SMALL}, {points} points, dropped "
        f"{small.coo_dropped_points} (expected {want}), warned {warned}")
    if not ok:
        raise SystemExit("chip_smoke: the COO overflow was not counted")
    del small

    got = list(dense.run(iter(frames), depth=2, stage_ahead=4))
    in_order = len(got) == len(frames) and all(torch.equal(a, b) for o, s in zip(got, single) for a, b in zip(o, s))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in dense.run(iter(frames * RUN_PASSES), depth=2, stage_ahead=4))
    torch.cuda.synchronize()
    run_fps = n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for f in frames * RUN_PASSES:
        dense(*f)
    torch.cuda.synchronize()
    call_fps = n / (time.perf_counter() - t0)
    out["run"] = dict(in_order_bitwise=in_order, frames=n, run_fps=run_fps, call_fps=call_fps)
    log(f"[{'ok' if in_order else 'FAIL'}] run(depth=2, stage_ahead=4) over {len(frames)} frames: in order, bitwise "
        f"the single calls; {run_fps:.1f} two-stream frames/s over {n} frames (one call at a time: {call_fps:.1f})")
    if not in_order:
        raise SystemExit("chip_smoke: run() differs from single calls")
    del dense, single, got

    fresh_peak()
    r = Recorder()
    with r.recording():
        fps = benchmark_throughput(state, height=H, width=W, batch=THROUGHPUT_B)
    peak = torch.cuda.max_memory_allocated()
    tp = check_new(r.calls, f"b{2 * THROUGHPUT_B}")
    checked.update(tp)
    out["throughput"] = dict(batch=THROUGHPUT_B, fps=fps, peak_bytes=peak, calls=len(r.calls), new_calls=len(tp))
    log(f"[ok] benchmark_throughput batch {THROUGHPUT_B} (B {2 * THROUGHPUT_B} in the net), bf16, {H}x{W}: "
        f"{fps:.1f} frames/s; {len(r.calls)} distinct kernel calls, all within their bars; "
        f"peak {peak / 2**20:.0f} MiB")
    return out, checked


# ---------------------------------------------------------------------------
# The residual conv's backward
# ---------------------------------------------------------------------------

RESIDUAL_CASES = ((32, 64, 2, H, W), (3, 32, 1, H, W))  # (cin, cout, stride, h, w): RGB encoders 1 and 0


def residual_check(g):
    """The residual form's autograd Function (``conv3x3_residual_trainable``)
    at the RGB encoders' shapes, batch 1, in f32 and bf16: output and
    gradients on the kernel path against the plain path (f32 within
    GRAD_BAR; bf16 within BF16_BAR, the output rounding, a recovered ReLU mask
    that flips included). Returns the errors; raises on a miss."""
    import torch

    from nconv_tpu_torch import kernels
    from nconv_tpu_torch.ops import conv3x3_residual_trainable

    names, found = ("out", "d_x", "d_w", "d_b", "d_shortcut"), {}
    for cin, cout, stride, h, w in RESIDUAL_CASES:
        for dtype, bar in ((torch.float32, GRAD_BAR), (torch.bfloat16, BF16_BAR)):
            r = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device="cuda") * scale).to(dtype)
            x = r(GUIDED_B, cin, h, w)
            wt, b, sc = r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), r(cout), r(cout, cin, 1, 1, scale=cin ** -0.5)
            cot = r(GUIDED_B, cout, (h - 1) // stride + 1, (w - 1) // stride + 1)
            got = {}
            for path in ("kernel", "plain"):
                leaves = [t.clone().requires_grad_() for t in (x, wt, b, sc)]
                kernels.reset_launch_counts()
                with plain_versions() if path == "plain" else contextlib.nullcontext():
                    y = conv3x3_residual_trainable([leaves[0]], *leaves[1:3], leaves[3], stride=stride)
                    y.backward(cot)
                torch.cuda.synchronize()
                got[path] = [y.detach()] + [t.grad for t in leaves]
                if path == "kernel":
                    counts = {k: v for k, v in kernels.launch_counts().items() if v}
            errs = {n: rel_rmse(a.float(), e.float()) for n, a, e in zip(names, got["kernel"], got["plain"])}
            tag = f"{cin}->{cout} s{stride} {str(dtype).replace('torch.', '')}"
            found[tag] = dict(errs=errs, bar=bar, launches=counts)
            ok = max(errs.values()) <= bar
            log(f"[{'ok' if ok else 'FAIL'}] residual backward {tag} {h}x{w} kernel vs plain: "
                + ", ".join(f"{n} {v:.2e}" for n, v in errs.items()) + f" (bar {bar:.0e}); launches {counts}")
            if not ok:
                raise SystemExit(f"chip_smoke: residual backward {tag}: {errs}")
    return found


# ---------------------------------------------------------------------------
# The command line: python -m nconv_tpu_torch, over the port's own data
# ---------------------------------------------------------------------------

NYU_H, NYU_W = 480, 640  # the NYU tree of phase 7
NYU_TRAIN, NYU_VAL, NYU_MASKS = 8, 2, 4
GRID_LRS, GRID_WDS = ("1e-2", "1e-3"), ("1e-7", "1e-2")
GRID_EPOCHS, GRID_B = 2, 4
INFER_FRAMES = 3  # an odd count: the last frame fills both streams
CELL_RTOL, LR_RTOL = 1e-5, 1e-6  # per-cell losses / lr, lockstep vs serial (tests/test_training.py:423)
STATE_RTOL, STATE_ATOL = 1e-4, 1e-6  # the winner's state
EVAL_RTOL = 1e-5  # eval's JSON against evaluate() called directly
STEP1_FORMS = ("nconv", "conv_kxk", "filtergrad")  # K1, K2's K x K form, K5
REPLAY_ORDER = ("serial", "lockstep", "lockstep", "serial")


def write_png_cycling_filters(path, rgb, filters=(0, 1, 2, 3, 4)):
    """An 8-bit RGB PNG whose rows take ``filters`` in turn (by default all
    five: None, Sub, Up, Average, Paeth), written from the PNG
    specification's filter definitions (independent of the port's encoder,
    which writes filter 0)."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = rgb.shape
    x = rgb.astype(np.int32).reshape(h, w * 3)
    left = np.zeros_like(x)
    left[:, 3:] = x[:, :-3]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, 3:] = x[:-1, :-3]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    kind = np.asarray(filters)[np.arange(h) % len(filters)]
    pred = np.stack([np.zeros_like(x), left, up, (left + up) // 2, paeth])[kind, np.arange(h)]
    raw = np.concatenate([kind[:, None].astype(np.uint8), ((x - pred) & 255).astype(np.uint8)], axis=1)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def nyu_tree(root, seed=0):
    """A NYU-layout tree (``<root>/<mode>/{gt,depth,img}``, ``<root>/mask``)
    at 480x640: smooth depth, camera-like RGB, a pool of 4 masks (two of
    them off-size, so the nearest resize runs). Returns the first image."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:NYU_H, 0:NYU_W].astype(np.float32)
    first = None
    for mode, n in (("train", NYU_TRAIN), ("val", NYU_VAL)):
        for sub in ("gt", "depth", "img"):
            (root / mode / sub).mkdir(parents=True)
        for i in range(n):
            ph = rng.random() * 6.28
            gt = (1 + 4 * (yy / NYU_H) + np.sin(xx / 61.0 + ph) * np.cos(yy / 47.0)).astype(np.float32)
            np.save(root / mode / "gt" / f"{i:04d}.npy", gt)
            np.save(root / mode / "depth" / f"{i:04d}.npy", gt * (rng.random(gt.shape) < 0.05))
            base = np.stack([xx / NYU_W, yy / NYU_H, 0.5 + 0.5 * np.sin(xx / 40.0 + ph)], -1) * 200
            img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
            write_png_cycling_filters(root / mode / "img" / f"{i:04d}.png", img)
            first = img if first is None else first
    (root / "mask").mkdir()
    for i, shape in enumerate([(NYU_H, NYU_W), (NYU_H, NYU_W), (NYU_H // 2, NYU_W // 2), (357, 479)]):
        np.save(root / "mask" / f"m{i}.npy", (rng.random(shape) < 0.1 + 0.05 * i).astype(np.float32))
    return first


def run_cli(argv, label):
    """``nconv_tpu_torch.cli.main(argv)`` on the card: (its standard output,
    wall seconds, the kernels it launched). A non-zero exit fails the phase."""
    import io as text_io

    import torch

    from nconv_tpu_torch import cli, kernels

    buf = text_io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    out = buf.getvalue()
    if rc != 0:
        raise SystemExit(f"chip_smoke: {label} exited {rc}:\n{out[-2000:]}")
    log(f"    {label}: {wall:.2f} s; launches {counts}; last line: {out.strip().splitlines()[-1][:300]}")
    return out, wall, counts


@contextmanager
def captured(module, name, into):
    """Record every return value of ``module.name`` in ``into``."""
    real = getattr(module, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        into.append(out)
        return out

    with mock.patch.object(module, name, spy):
        yield


def close(a, b, rtol, atol=0.0):
    import numpy as np

    return np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)


def grid_compare(serial, lockstep, label):
    """Hold a lockstep grid's (FitResult, lr, wd) to a serial one's:
    the same winner, every cell's losses and lr, the winner's state."""
    (best_s, lr_s, wd_s, cells_s), (best_p, lr_p, wd_p) = serial, lockstep
    cells_p = best_p.history["cells"]
    bad = [c for c in cells_p if not (
        close(cells_p[c]["train_loss"], cells_s[c]["train_loss"], CELL_RTOL)
        and close(cells_p[c]["val_loss"], cells_s[c]["val_loss"], CELL_RTOL)
        and close(cells_p[c]["lr"], cells_s[c]["lr"], LR_RTOL))]
    state_ok = all(close(best_p.best_variables[k], v, STATE_RTOL, STATE_ATOL)
                   for k, v in best_s.best_variables.items())
    ok = (lr_p, wd_p) == (lr_s, wd_s) and set(cells_p) == set(cells_s) and not bad and state_ok
    log(f"[{'ok' if ok else 'FAIL'}] {label}: winner lr {lr_p} wd {wd_p} (serial lr {lr_s} wd {wd_s}); "
        f"cells off their bars {bad}; winner's state within rtol {STATE_RTOL} atol {STATE_ATOL}: {state_ok}")
    if not ok:
        raise SystemExit(f"chip_smoke: {label} differs from the serial grid")


def cli_phase(reference):
    """Phase 7: the port's command line on the card, everything under
    build/chip_smoke/cli. ``reference`` holds phases 3-6's numbers to print
    beside the benchmarks'."""
    import shutil

    import numpy as np
    import torch

    from nconv_tpu_torch import training
    from nconv_tpu_torch.data import Loader, NYUDataset, io, png
    from nconv_tpu_torch.models import GuidedDepthNet, NConvUNet
    from nconv_tpu_torch.runtime import StreamingEngine
    from nconv_tpu_torch.training import (
        GridSearchConfig, OptimizerConfig, TrainConfig, UnguidedTask, evaluate, grid_search,
        load_best, make_guided_predict, make_unguided_predict, parallel_grid_search,
    )

    t_phase = time.perf_counter()
    base = Path(__file__).resolve().parent / "build" / "chip_smoke" / "cli"
    shutil.rmtree(base, ignore_errors=True)  # a stale grid_results.json would skip cells
    base.mkdir(parents=True)
    out = {}

    # (a) the data: a NYU tree written with every row filter, one image
    # decoded against the array written, the decode time of a KITTI frame
    root = base / "nyu"
    first = nyu_tree(root)
    decoded = png.read(root / "train" / "img" / "0000.png")
    bitwise = decoded.color_type == 2 and np.array_equal(decoded.samples, first)
    kitti_rgb = synthetic_frames(1, seed=3)[0][0]
    write_png_cycling_filters(base / "kitti.png", kitti_rgb)
    decode_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        d = png.read(base / "kitti.png")
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    bitwise &= np.array_equal(d.samples, kitti_rgb)
    out["data"] = dict(decoded_bitwise=bitwise, decode_ms_352x1216=statistics.median(decode_ms),
                       decode_ms_all=decode_ms)
    log(f"[{'ok' if bitwise else 'FAIL'}] data: NYU tree {NYU_H}x{NYU_W}, {NYU_TRAIN} train / {NYU_VAL} val "
        f"frames, {NYU_MASKS} masks; PNGs (rows through all five filters) decode bitwise the arrays written; "
        f"decode of a {H}x{W} RGB PNG {statistics.median(decode_ms):.1f} ms (median of 3: "
        + ", ".join(f"{v:.1f}" for v in decode_ms) + ")")
    if not bitwise:
        raise SystemExit("chip_smoke: the PNG decoder does not return the image written")

    # (b) the step-1 grid, one cell after another, then in lockstep
    ck = str(base / "ck")
    nyu = ["--dataset", "nyu", "--root", str(root), "--num-workers", "0", "--checkpoint-dir", ck]
    grid = ["train-step1", *nyu, "--lr", *GRID_LRS, "--weight-decay", *GRID_WDS,
            "--epochs", str(GRID_EPOCHS), "--batch-size", str(GRID_B)]
    runs = {}
    for name, extra in (("serial", []), ("lockstep", ["--grid-parallel"])):
        fits = []
        with captured(training, "grid_search" if name == "serial" else "parallel_grid_search", fits):
            _, wall, counts = run_cli(grid + ["--name", name, *extra], f"train-step1 grid, {name}")
        missing = [k for k in STEP1_FORMS if not counts.get(k)]
        if missing:
            raise SystemExit(f"chip_smoke: train-step1 {name} launched no {missing}")
        runs[name] = dict(wall_s=wall, counts=counts, winner=fits[0][1:])
    with open(Path(ck) / "serial_grid" / "grid_results.json") as f:
        serial_cells = {c: v["history"] for c, v in json.load(f).items()}
    lock_cells = fits[0][0].history["cells"]
    # the serial grid's first cell reads the loaders' first epochs, as every
    # lockstep cell does; its later cells read later shuffles and masks
    c0 = f"lr{float(GRID_LRS[0]):g}_wd{float(GRID_WDS[0]):g}"
    cell0_ok = (close(lock_cells[c0]["train_loss"], serial_cells[c0]["train_loss"], CELL_RTOL)
                and close(lock_cells[c0]["val_loss"], serial_cells[c0]["val_loss"], CELL_RTOL)
                and close(lock_cells[c0]["lr"], serial_cells[c0]["lr"], LR_RTOL))
    finite = all(np.isfinite(h[k]).all() for cells in (serial_cells, lock_cells) for h in cells.values()
                 for k in ("train_loss", "val_loss"))
    out["grid_cli"] = dict(runs=runs, serial_cells=serial_cells, lockstep_cells=lock_cells)
    log(f"[{'ok' if cell0_ok and finite else 'FAIL'}] train-step1 grid through the CLI ({len(GRID_LRS)} x "
        f"{len(GRID_WDS)} cells, {GRID_EPOCHS} epochs, B {GRID_B}): serial {runs['serial']['wall_s']:.2f} s, "
        f"lockstep {runs['lockstep']['wall_s']:.2f} s; cell {c0} (the same data in both) within rtol "
        f"{CELL_RTOL}: {cell0_ok}; winners serial {runs['serial']['winner']} lockstep {runs['lockstep']['winner']}")
    if not (cell0_ok and finite):
        raise SystemExit("chip_smoke: the CLI's lockstep grid differs from its serial grid")

    # the same grid on the same batches for every cell (the tree decoded once),
    # serial and lockstep in turns
    batches = {m: list(Loader(NYUDataset(str(root), m), GRID_B if m == "train" else 1)) for m in ("train", "val")}
    cfg = TrainConfig(epochs=GRID_EPOCHS, batch_size=GRID_B, log_every=0,
                      optimizer=OptimizerConfig("adamw", 1e-2, 1e-7))
    gcfg = GridSearchConfig([float(v) for v in GRID_LRS], [float(v) for v in GRID_WDS])
    factory = lambda: UnguidedTask(NConvUNet(device="cuda"))
    loaders = (lambda: iter(batches["train"]), lambda: iter(batches["val"]))
    quiet = lambda m: None
    walls, serial = {}, None
    for i, variant in enumerate(REPLAY_ORDER):  # in turns: the first runs of a shape pay its set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if variant == "serial":
            res = grid_search(factory, cfg, gcfg, *loaders, log_fn=quiet, checkpoint_dir=str(base / f"replay_{i}"))
        else:
            res = parallel_grid_search(factory, cfg, gcfg, *loaders, log_fn=quiet)
        torch.cuda.synchronize()
        walls.setdefault(variant, []).append(time.perf_counter() - t0)
        if variant == "serial" and serial is None:
            with open(base / f"replay_{i}" / "grid_results.json") as f:
                serial = (*res, {c: v["history"] for c, v in json.load(f).items()})
        elif variant != "serial":
            grid_compare(serial, res, f"{variant} grid on the same batches (run {i})")
    out["grid_replay"] = dict(walls_s=walls)
    log("    grid walls on the same batches, s, in the order run " + " ".join(REPLAY_ORDER) + ": "
        + "; ".join(f"{k} " + " / ".join(f"{t:.3f}" for t in v) for k, v in walls.items()))

    # (c) guided training from (b)'s best step 1, f32 and mixed
    step1_ck = str(Path(ck) / "serial")
    out["train_step2"] = {}
    for prec in ("f32", "bf16"):
        fits = []
        with captured(training.Trainer, "fit", fits):
            _, wall, counts = run_cli(["train-step2", *nyu, "--step1-checkpoint", step1_ck, "--epochs", "1",
                                       "--batch-size", "1", "--name", f"guided_{prec}", "--precision", prec],
                                      f"train-step2 --precision {prec}")
        h = fits[0].history
        missing = [k for k in PER_GUIDED_STEP[prec] if not counts.get(k)]
        ok = np.isfinite(h["train_loss"] + h["val_loss"]).all() and not missing
        out["train_step2"][prec] = dict(wall_s=wall, counts=counts, history=h)
        log(f"[{'ok' if ok else 'FAIL'}] train-step2 {prec}: losses {h['train_loss']} / val {h['val_loss']}; "
            f"forms without a launch {missing}")
        if not ok:
            raise SystemExit(f"chip_smoke: train-step2 {prec}: {h} {missing}")

    # (d) eval on (b)'s and (c)'s checkpoints against evaluate() called directly
    out["eval"] = {}
    for model_name, ckpt in (("unguided", step1_ck), ("guided", str(Path(ck) / "guided_f32"))):
        text, wall, counts = run_cli(["eval", *nyu, "--model", model_name, "--checkpoint", ckpt,
                                      "--split", "val", "--batch-size", "1"], f"eval --model {model_name}")
        got = json.loads(text.strip().splitlines()[-1])
        model = (GuidedDepthNet if model_name == "guided" else NConvUNet)(device="cuda")
        model.load_state_dict(load_best(ckpt))
        predict = (make_guided_predict if model_name == "guided" else make_unguided_predict)(model)
        want = evaluate(predict, Loader(NYUDataset(str(root), "val"), 1))
        ok = got.keys() == want.keys() and all(close(got[k], round(want[k], 6), EVAL_RTOL, 1e-6) for k in want)
        out["eval"][model_name] = dict(cli=got, direct=want, wall_s=wall, counts=counts)
        log(f"[{'ok' if ok else 'FAIL'}] eval --model {model_name}: {got}; evaluate() directly: "
            + ", ".join(f"{k} {v:.6f}" for k, v in want.items()))
        if not ok:
            raise SystemExit(f"chip_smoke: eval --model {model_name} differs from evaluate()")

    # (e) infer at KITTI 352x1216: each depth PNG bitwise the engine's own
    # output after the uint16 rounding
    frames_dir = base / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(synthetic_frames(INFER_FRAMES, seed=5)):
        write_png_cycling_filters(frames_dir / f"{i}_rgb.png", f[0])
        io.save_depth_png16(str(frames_dir / f"{i}_depth.png"), f[1])
    guided_ck = str(Path(ck) / "guided_f32")
    state = load_best(guided_ck)
    loaded = [(io.load_rgb(str(frames_dir / f"{i}_rgb.png")), io.load_depth_png16(str(frames_dir / f"{i}_depth.png")))
              for i in range(INFER_FRAMES)]
    out["infer"] = {}
    for mixed in (False, True):
        label = "mixed" if mixed else "f32"
        outdir = base / f"infer_{label}"
        _, wall, counts = run_cli(["infer", "--checkpoint", guided_ck, "--rgb-glob", str(frames_dir / "*_rgb.png"),
                                   "--depth-glob", str(frames_dir / "*_depth.png"), "--out-dir", str(outdir),
                                   "--height", str(H), "--width", str(W), *(["--mixed"] if mixed else [])],
                                  f"infer {label}")
        eng = StreamingEngine(state, height=H, width=W,
                              model=GuidedDepthNet(dtype=torch.bfloat16 if mixed else torch.float32, device="cuda"))
        pairs = [(0, 1), (2, 2)]
        want = {}
        for a, b in pairs:
            o0, o1 = eng(*loaded[a], *loaded[b])
            for i, o in ((a, o0), (b, o1)):
                want.setdefault(i, np.clip(o[0, :, :, 0].float().cpu().numpy().astype(np.float64) * 256.0,
                                           0, 65535).astype(np.uint16))
        del eng
        bad = [i for i in range(INFER_FRAMES)
               if not np.array_equal(png.read(outdir / f"{i}_rgb_depth.png").samples, want[i])]
        vis = [png.read(outdir / f"{i}_rgb_vis.png").samples for i in range(INFER_FRAMES)]
        vis_ok = all(v.shape == (H, W, 3) and v.dtype == np.uint8 for v in vis)
        ok = not bad and vis_ok
        out["infer"][label] = dict(wall_s=wall, counts=counts, bitwise=not bad, vis_ok=vis_ok)
        log(f"[{'ok' if ok else 'FAIL'}] infer {label}, {INFER_FRAMES} frames at {H}x{W}: depth PNGs bitwise the "
            f"engine's output after uint16 rounding (frames off {bad}); vis PNGs (H, W, 3) uint8: {vis_ok}")
        if not ok:
            raise SystemExit(f"chip_smoke: infer {label}: depth PNGs {bad} differ, vis ok {vis_ok}")

    # (f) the benchmark commands and one profile, beside phases 3-6's numbers
    out["bench"] = {}
    size = ["--height", str(H), "--width", str(W)]
    for name, extra in (("latency", []), ("throughput", ["--throughput", "--batch", "8"]),
                        ("train_f32", ["--train"]), ("train_bf16", ["--train", "--precision", "bf16"])):
        text, wall, counts = run_cli(["bench", *size, *extra], " ".join(["bench", *extra]))
        out["bench"][name] = dict(json=json.loads(text.strip().splitlines()[-1]), wall_s=wall, counts=counts)
    text, wall, counts = run_cli(["profile", *size, "--mixed"], "profile --mixed")
    prof = json.loads(text.strip().splitlines()[-1])
    out["profile_mixed"] = dict(json=prof, wall_s=wall, counts=counts)
    b = out["bench"]
    log(f"    bench (f32 frame, ms): " + "; ".join(f"{k} p50 {v['p50_ms']:.3f}" for k, v in b["latency"]["json"].items())
        + f" [phase 3: " + "; ".join(f"{k} p50 {v['p50_ms']:.3f}" for k, v in reference["f32_frame"].items()) + "]")
    log(f"    bench --throughput --batch 8: {b['throughput']['json']['throughput_fps']} frames/s "
        f"[phase 3b: {reference['throughput_fps']:.1f}]")
    log(f"    bench --train: step 1 B 4 {b['train_f32']['json']['unguided_train_ms_per_batch']} ms, guided B 1 f32 "
        f"{b['train_f32']['json']['guided_train_ms_per_batch']} ms, bf16 "
        f"{b['train_bf16']['json']['guided_train_ms_per_batch']} ms "
        f"[phases 4-6 p50: {reference['step1_ms']:.3f}, {reference['guided_f32_ms']:.3f}, "
        f"{reference['guided_bf16_ms']:.3f}]")
    log(f"    profile --mixed: wall {prof['wall_ms_per_request']:.3f} ms a request, device busy "
        f"{prof['device_busy_ms_per_request']} ms, share {prof['device_busy_share']}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[ok] phase 7 (the command line): {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Export and interop: the torch.export program, the ONNX artifact, convert
# ---------------------------------------------------------------------------

EXPORT_BATCHES = (1, 2)  # served by one program with a dynamic batch axis

# run in a fresh process that imports only the port: load the program, run
# it at each batch, count its launches, time it; argv: program, inputs file,
# outputs file, repetitions
RELOAD_SCRIPT = r"""
import json, statistics, sys, time
import torch
from nconv_tpu_torch import kernels
from nconv_tpu_torch.runtime.export import load_exported

path, inputs_path, outputs_path, reps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
t0 = time.perf_counter()
call = load_exported(path)
load_s = time.perf_counter() - t0
inputs = torch.load(inputs_path)
outs, counts = {}, {}
for b, args in inputs.items():
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs[b] = call(*args)
    torch.cuda.synchronize()
    counts[b] = {k: n for k, n in kernels.launch_counts().items() if n}
torch.save(outs, outputs_path)
times = []
for i in range(reps + 1):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    call(*inputs[1])
    e.record()
    e.synchronize()
    times.append(s.elapsed_time(e))
repo = sorted({m.split(".")[0] for m in sys.modules} & {"nconv_tpu", "nconv_tpu_torch", "chip_smoke", "jax", "flax"})
print(json.dumps({"load_s": load_s, "counts": counts, "p50_ms": statistics.median(times[1:]), "packages": repo}))
"""


def export_inputs():
    """f32 NHWC inputs of the contract, at each of ``EXPORT_BATCHES``, from
    the first frames of :func:`synthetic_frames` (seed 5)."""
    import numpy as np
    import torch

    frames = synthetic_frames(max(EXPORT_BATCHES), seed=5)

    def stack(i, b):
        x = np.stack([f[i] for f in frames[:b]]).astype(np.float32)
        return torch.from_numpy(x if x.ndim == 4 else x[..., None]).cuda()

    return {b: [stack(i, b) for i in range(4)] for b in EXPORT_BATCHES}


def export_program_phase(state, replay_ms, smi):
    """Phase 8 (a): the phase-3 folded model, f32 and mixed, exported with a
    dynamic batch on the card, saved, and reloaded in a fresh process that
    imports only the port; at b = 1 and 2 its outputs bitwise the eager
    ``export``'s and its launches the eager call's; p50s beside the eager
    call's and the phase-3 graph replay's (``replay_ms``)."""
    import shutil

    import torch

    from nconv_tpu_torch import kernels
    from nconv_tpu_torch.models import GuidedDepthNet, maybe_fold
    from nconv_tpu_torch.runtime.export import export_guided, save_exported

    base = Path(__file__).resolve().parent / "build" / "chip_smoke" / "export"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    inputs = export_inputs()
    torch.save(inputs, base / "inputs.pt")
    out = {}
    for name in ("f32", "mixed"):
        per = PER_FRAME_FLOAT_RGB[name]
        model, st = maybe_fold(GuidedDepthNet(dtype=getattr(torch, SCHEDULES[name]), device="cuda"), state)
        model.load_state_dict(st)
        t0 = time.perf_counter()
        ep = export_guided(model, height=H, width=W)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path = save_exported(ep, base / f"guided_{name}.pt2")
        save_s = time.perf_counter() - t0
        del ep
        eager, eager_counts = {}, {}
        for b, args in inputs.items():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            eager[b] = model.export(*args)
            torch.cuda.synchronize()
            eager_counts[b] = nonzero(kernels.launch_counts())
        eager_ms = time_ms(lambda: model.export(*inputs[1]))
        outputs = base / f"outputs_{name}.pt"
        proc = subprocess.run([sys.executable, "-c", RELOAD_SCRIPT, path, str(base / "inputs.pt"), str(outputs),
                               str(REPS)], capture_output=True, text=True, cwd=Path(__file__).resolve().parent)
        if proc.returncode != 0:
            raise SystemExit(f"chip_smoke: export {name}: the reloading process failed:\n{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.load(outputs)
        bitwise = {b: all(torch.equal(g, e) for g, e in zip(got[b], eager[b])) for b in EXPORT_BATCHES}
        counts = {b: res["counts"][str(b)] for b in EXPORT_BATCHES}
        shapes = all(tuple(o.shape) == (b, H, W, 1) and torch.isfinite(o).all() and o[:, 45:H - 45, 20:].abs().max() > 0
                     for b in EXPORT_BATCHES for o in got[b])
        ok = (all(bitwise.values()) and shapes and res["packages"] == ["nconv_tpu_torch"]
              and all(counts[b] == eager_counts[b] == per for b in EXPORT_BATCHES))
        out[name] = dict(export_s=export_s, save_s=save_s, bytes=Path(path).stat().st_size, load_s=res["load_s"],
                         program_p50_ms=res["p50_ms"], eager_p50_ms=eager_ms, replay_p50_ms=replay_ms.get(name),
                         bitwise=bitwise, counts=counts, eager_counts=eager_counts, packages=res["packages"])
        log(f"[{'ok' if ok else 'FAIL'}] export {name}: one .pt2 program, b = {EXPORT_BATCHES} bitwise the eager "
            f"export {bitwise}; its launches {counts[1]} (eager {eager_counts[1]}, expected {per}); the reloading "
            f"process imported {res['packages']}")
        log(f"    export {name} ({smi}): export {export_s:.2f} s, save {save_s:.2f} s "
            f"({out[name]['bytes'] / 2**20:.2f} MiB), reload in a fresh process {res['load_s']:.2f} s; p50 of a "
            f"two-stream b = 1 call (CUDA events): program {res['p50_ms']:.3f} ms, eager export {eager_ms:.3f} ms, "
            f"phase-3 graph replay (device) {replay_ms.get(name, float('nan')):.3f} ms")
        if not ok:
            raise SystemExit(f"chip_smoke: export {name}: bitwise {bitwise}, shapes ok {shapes}, counts {counts} "
                             f"against eager {eager_counts}, packages {res['packages']}")
        del model, eager, got
    return out


ONNX_H, ONNX_W = 480, 640  # the reference's deployed ONNX geometry
ONNX_EXEC_H, ONNX_EXEC_W = 128, 160  # executed by the port's numpy interpreter (nonzero inside the border)
ONNX_BAR = 1e-4  # the f32 guided bar
CONVERT_ATOL = 1e-6  # a softplus / inverse-softplus round trip of the step-1 kernels


def onnx_phase(state, smi):
    """Phase 8 (b): the deployment ONNX, traced on a CPU copy of the
    weights: at 480x640 with the contract checked; at 128x160 executed by
    the port's numpy interpreter at b = 2 against the card's plain path."""
    import numpy as np
    import torch

    from nconv_tpu_torch.compat import export_guided_onnx, read_onnx_summary
    from nconv_tpu_torch.compat.onnx_exec import run_onnx
    from nconv_tpu_torch.compat.onnx_export import INPUT_NAMES, check_contract, selftest_frames
    from nconv_tpu_torch.models import GuidedDepthNet

    base = Path(__file__).resolve().parent / "build" / "chip_smoke" / "export"
    t0 = time.perf_counter()
    path = export_guided_onnx(state, str(base / f"guided_{ONNX_H}x{ONNX_W}.onnx"), height=ONNX_H, width=ONNX_W)
    export_s = time.perf_counter() - t0
    summary = read_onnx_summary(path)
    check_contract(summary)
    small = export_guided_onnx(state, str(base / f"guided_{ONNX_EXEC_H}x{ONNX_EXEC_W}.onnx"),
                               height=ONNX_EXEC_H, width=ONNX_EXEC_W)
    rgb, dep = selftest_frames(ONNX_EXEC_H, ONNX_EXEC_W, batch=2)
    feeds = dict(zip(INPUT_NAMES, (rgb, dep, rgb[::-1].copy(), dep[::-1].copy())))
    t0 = time.perf_counter()
    got = run_onnx(small, feeds)
    exec_s = time.perf_counter() - t0
    model = GuidedDepthNet(device="cuda")
    model.load_state_dict(state)
    with torch.no_grad(), plain_versions():
        want = model.export(*(torch.from_numpy(feeds[n]).cuda().permute(0, 2, 3, 1) for n in INPUT_NAMES))
    want = [w.permute(0, 3, 1, 2) for w in want]
    errs = [rel_rmse(torch.from_numpy(np.ascontiguousarray(g)).cuda(), w) for g, w in zip(got, want)]
    nonzero_out = all(float(w.abs().mean()) > 0.1 for w in want)
    ok = max(errs) < ONNX_BAR and nonzero_out
    log(f"[{'ok' if ok else 'FAIL'}] onnx: {ONNX_H}x{ONNX_W} artifact ({summary['total_weight_floats']} "
        f"initializer values, {sum(summary['op_counts'].values())} nodes) has the contract, exported in "
        f"{export_s:.2f} s; the {ONNX_EXEC_H}x{ONNX_EXEC_W} artifact run by the port's interpreter at b = 2 "
        f"({exec_s:.2f} s on the host) against the card's plain path: rel RMSE {max(errs):.2e} (bar {ONNX_BAR:.0e}), "
        f"outputs nonzero {nonzero_out} ({smi})")
    if not ok:
        raise SystemExit(f"chip_smoke: onnx: rel RMSE {errs}, nonzero {nonzero_out}")
    return dict(export_s=export_s, exec_s=exec_s, rel_rmse=errs, op_counts=summary["op_counts"],
                weight_floats=summary["total_weight_floats"])


def interop_cli_phase(state):
    """Phase 8 (c): ``export`` (pt2 on the card with its selftest, onnx with
    its selftest) and ``convert --reverse`` then ``convert`` back through
    ``run_cli``; the converted state equal to the one written."""
    import numpy as np

    from nconv_tpu_torch.training import load_best, save_best

    base = Path(__file__).resolve().parent / "build" / "chip_smoke" / "export" / "cli"
    base.mkdir(parents=True)
    ck = save_best(base, "guided", {k: v.cpu() for k, v in state.items()})
    out = {}
    for label, argv in (
            ("export --selftest", ["export", "--checkpoint", ck, "--out", str(base / "guided.pt2"), "--height",
                                   str(H), "--width", str(W), "--selftest"]),
            ("export --format onnx --selftest", ["export", "--checkpoint", ck, "--out", str(base / "guided.onnx"),
                                                 "--height", str(ONNX_EXEC_H), "--width", str(ONNX_EXEC_W),
                                                 "--format", "onnx", "--selftest"]),
            ("convert --reverse", ["convert", "--reverse", "--checkpoint", ck, "--pth", str(base / "ref.pth.tar")]),
            ("convert", ["convert", "--pth", str(base / "ref.pth.tar"), "--out", str(base / "back")])):
        text, wall, counts = run_cli(argv, label)
        out[label] = dict(wall_s=wall, counts=counts, last=text.strip().splitlines()[-1])
    back, want = load_best(base / "back"), load_best(ck)
    same = back.keys() == want.keys() and all(np.allclose(back[k].numpy(), want[k].numpy(), rtol=0, atol=CONVERT_ATOL)
                                              for k in want)
    pt2_counts = out["export --selftest"]["counts"]
    ok = same and all(pt2_counts.get(k) for k in PER_FRAME["f32"])
    log(f"[{'ok' if ok else 'FAIL'}] export / convert commands: the pt2 selftest launched {pt2_counts}; "
        f"convert --reverse then convert gives back the state written (atol {CONVERT_ATOL}): {same}")
    if not ok:
        raise SystemExit(f"chip_smoke: interop commands: state back {same}, pt2 launches {pt2_counts}")
    return out


# ---------------------------------------------------------------------------
# Data parallelism and the native host data path
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_B = {"step1": 4, "guided": 2}  # the whole batch of the world-size-2 steps; a rank holds half
DP_RIGS, DP_FPS_RIGS, DP_FPS_CALLS = 3, 8, 5  # the engine's ragged N (padded to 4); frames/s at N = 8
DP_ENGINE_BARS = {"f32": 1e-6, "mixed": 1e-4}  # a rig rel RMSE against the single-rig export
DECODE_FILES, DECODE_THREADS = 16, 4


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_cfg():
    from nconv_tpu_torch.training import OptimizerConfig, TrainConfig

    # a rate of 0: the step leaves each gradient in .grad and the weights as they were
    return TrainConfig(log_every=0, optimizer=OptimizerConfig("sgd", 0.0, 0.0, 0.0))


def _dp_task(case, seed, step1_state):
    from nconv_tpu_torch.models import GuidedDepthNet, NConvUNet
    from nconv_tpu_torch.training import GuidedTask, UnguidedTask

    if case == "step1":
        return UnguidedTask(NConvUNet(device="cuda", seed=seed))
    return GuidedTask(GuidedDepthNet(device="cuda", seed=seed), step1_state=step1_state)


def dp_rank_main(rank, port, work):
    """A rank of phase 9's world-size-2 group: gloo over CUDA tensors, both
    ranks on cuda:0 (NCCL refuses two ranks on one device). Each rank's
    model starts from another seed (the trainer broadcasts rank 0's); one
    train step of step 1 and one of guided f32 (train-mode BN across the
    ranks) on its half of the batch; the gradients go to ``work``."""
    import torch
    import torch.distributed as dist

    from nconv_tpu_torch import kernels, parallel
    from nconv_tpu_torch.training import Trainer

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=DP_WORLD)
    mesh = parallel.make_mesh(devices=["cuda:0"])
    inp = torch.load(Path(work) / "inputs.pt", weights_only=False)
    out = {"mesh": (mesh.rank, mesh.world, str(mesh.device), dist.get_backend())}
    for case in ("step1", "guided"):
        trainer = Trainer(_dp_task(case, rank, inp["step1_state"]), _dp_cfg(), log_fn=lambda m: None, mesh=mesh)
        shard = {k: torch.from_numpy(v).cuda() for k, v in parallel.shard_batch(inp[case], mesh).items()}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(shard))
        torch.cuda.synchronize()
        out[case] = dict(loss=loss, grads={n: p.grad.double().cpu() for n, p in trainer.model.named_parameters()
                                           if p.grad is not None},
                         launches=nonzero(kernels.launch_counts()), step_s=time.perf_counter() - t0,
                         batch=int(shard["gt"].shape[0]))
    torch.save(out, Path(work) / f"rank{rank}.pt")
    dist.destroy_process_group()


def dp_training():
    """(a) world size 1 over NCCL bitwise the plain Trainer; (b) world size
    2 over gloo on the one card against one process on the whole batch."""
    import torch
    import torch.distributed as dist

    from nconv_tpu_torch import parallel
    from nconv_tpu_torch.data import bench_batch
    from nconv_tpu_torch.models import NConvUNet
    from nconv_tpu_torch.training import OptimizerConfig, TrainConfig, Trainer, UnguidedTask

    out = {}
    # (a) one adamw step of step 1 at B = 4 through a world-size-1 NCCL mesh
    batch = {k: torch.from_numpy(v).cuda() for k, v in bench_batch(TRAIN_B, H, W).items()}
    cfg = TrainConfig(log_every=0, optimizer=OptimizerConfig("adamw", 1e-3, 1e-7))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh()
        runs = []
        for m in (mesh, None):
            t = Trainer(UnguidedTask(NConvUNet(device="cuda", seed=0)), cfg, log_fn=lambda s: None, mesh=m)
            loss = t.train_step(batch)
            runs.append((loss, {n: p.grad for n, p in t.model.named_parameters()}, t.model.state_dict()))
        torch.cuda.synchronize()
        (lm, gm, sm), (lp, gp, sp) = runs
        bitwise = (torch.equal(lm, lp) and all(torch.equal(gm[k], gp[k]) for k in gp)
                   and all(torch.equal(sm[k], sp[k]) for k in sp))
        out["world1_nccl"] = dict(backend=dist.get_backend(), world=mesh.world, device=str(mesh.device),
                                  bitwise=bitwise, loss=float(lm))
    finally:
        dist.destroy_process_group()
    log(f"[{'ok' if bitwise else 'FAIL'}] data-parallel step 1, world size 1 over NCCL on {mesh.device}, B {TRAIN_B}: "
        f"loss, every gradient and every weight after an adamw step bitwise the plain Trainer's")
    if not bitwise:
        raise SystemExit("chip_smoke: a world-size-1 mesh differs from the plain Trainer")

    # (b) world size 2: two processes on cuda:0 over gloo
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "dp"
    work.mkdir(parents=True, exist_ok=True)
    step1_state = NConvUNet(device="cuda", seed=0).state_dict()
    batches = {c: bench_batch(b, H, W) for c, b in DP_B.items()}
    torch.save({**batches, "step1_state": {k: v.cpu() for k, v in step1_state.items()}}, work / "inputs.pt")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank", str(r), str(port),
                               str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DP_WORLD)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    spawn_s = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"chip_smoke: data-parallel rank {r} failed (rc {p.returncode}):\n{text[-4000:]}")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]
    cfg = _dp_cfg()
    for case in ("step1", "guided"):
        whole = {k: torch.from_numpy(v).cuda() for k, v in batches[case].items()}
        if case == "step1":
            step = lambda dtype, plain: step_grads(whole, dtype, cfg, plain=plain)
        else:
            from nconv_tpu_torch.models import GuidedDepthNet

            state0 = GuidedDepthNet(device="cuda", seed=0).state_dict()
            step = lambda dtype, plain: guided_step(whole, dtype, cfg, state0, step1_state, plain=plain)[:2]
        (loss_k, grads_k), (_, grads_p), (loss_64, grads_64) = (
            step(torch.float32, False), step(torch.float32, True), step(torch.float64, True))
        r0, r1 = (r[case] for r in ranks)
        same = r0["loss"] == r1["loss"] and all(torch.equal(r0["grads"][k], r1["grads"][k]) for k in r0["grads"])
        if not same or set(r0["grads"]) != set(grads_k):
            raise SystemExit(f"chip_smoke: the two ranks' {case} losses or gradients differ")
        sharded = {k: v.cuda() for k, v in r0["grads"].items()}
        label = f"data-parallel {case}, world size 2 (gloo, both ranks on cuda:0, B {DP_B[case]} = 2 x {r0['batch']})"
        loss_err, checks = grad_checks(r0["loss"], sharded, loss_k, grads_k, loss_64, grads_64,
                                       label + ", against one process on the whole batch", plain_grads=grads_p)
        out[f"world2_{case}"] = dict(loss=r0["loss"], whole_loss=loss_k, loss_rel=loss_err,
                                     worst_grad=max(c["vs_plain"] / c["bar"] for c in checks.values()),
                                     launches=r0["launches"], step_s=r0["step_s"], mesh=ranks[0]["mesh"])
        log(f"    {case} rank 0 launched {r0['launches']} in its step ({r0['step_s']:.2f} s, first step of the "
            f"process); worst gradient at {out[f'world2_{case}']['worst_grad']:.3f} of its bar")
    out["world2_spawn_s"] = spawn_s
    log(f"[ok] world size 2: ranks {[r['mesh'] for r in ranks]}, both ranks bitwise equal, {spawn_s:.1f} s "
        f"for both processes")
    return out


def dp_engine(state, throughput_fps):
    """``DataParallelEngine`` on [cuda:0] and [cuda:0, cuda:0]: N = 3 rigs
    against a single-rig ``export`` of each, and frames/s at N = 8."""
    import numpy as np
    import torch

    from nconv_tpu_torch.parallel import DataParallelEngine

    frames = synthetic_frames(DP_FPS_RIGS, seed=5)
    # (N, H, W, C) float32 stacks of rgb0, depth0, rgb1, depth1
    stack = lambda i, n: np.stack([f[i] if i % 2 == 0 else f[i][..., None] for f in frames[:n]]).astype(np.float32)
    out = {}
    for sched in SCHEDULES:
        dtype = getattr(torch, SCHEDULES[sched])
        rigs = [stack(i, DP_RIGS) for i in range(4)]
        single = DataParallelEngine(state, height=H, width=W, devices=["cuda:0"], dtype=dtype).replicas[0]
        want = []
        with torch.no_grad():
            for n in range(DP_RIGS):
                want.append(single.export(*(torch.from_numpy(a[n:n + 1]).cuda() for a in rigs)))
        del single
        for devs in (["cuda:0"], ["cuda:0", "cuda:0"]):
            eng = DataParallelEngine(state, height=H, width=W, devices=devs, dtype=dtype)
            got = eng(*rigs)
            err = max(rel_rmse(got[s][n:n + 1], want[n][s]) for n in range(DP_RIGS) for s in (0, 1))
            bitwise = all(torch.equal(got[s][n:n + 1], want[n][s]) for n in range(DP_RIGS) for s in (0, 1))
            shapes_ok = all(t.shape == (DP_RIGS, H, W, 1) and torch.isfinite(t).all() for t in got)
            big = [stack(i, DP_FPS_RIGS) for i in range(4)]
            eng(*big)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_FPS_CALLS):
                eng(*big)
            torch.cuda.synchronize()
            fps = 2 * DP_FPS_RIGS * DP_FPS_CALLS / (time.perf_counter() - t0)
            key = f"{sched}_x{len(devs)}"
            ok = shapes_ok and err <= DP_ENGINE_BARS[sched]
            out[key] = dict(devices=devs, rel_rmse=err, bitwise=bitwise, fps_n8=fps)
            log(f"[{'ok' if ok else 'FAIL'}] DataParallelEngine {sched} on {devs}: N {DP_RIGS} (padded to "
                f"{-(-DP_RIGS // len(devs)) * len(devs)}) against a single-rig export of each, rel RMSE {err:.2e} "
                f"(bar {DP_ENGINE_BARS[sched]:.0e}), bitwise {bitwise}; N {DP_FPS_RIGS}: {fps:.1f} frames/s "
                f"(2 a rig; host float32 stacks copied each call) beside benchmark_throughput's {throughput_fps:.1f} "
                f"(bf16, one graph)")
            if not ok:
                raise SystemExit(f"chip_smoke: DataParallelEngine {sched} on {devs} misses its bar")
            del eng, got
    return out


def native_phase(state, frames):
    """The C host data path: encoders against ``wires.py`` with host ms,
    the engines' ``synced`` / ``e2e`` p50 with the C encoders and with the
    plain ones, the C PNG readers bitwise ``png.py``'s plain unfilter with
    ms a 352x1216 frame by filter type, and the 4-thread / 1-thread rate.
    Prints its numbers and asserts none of them."""
    import warnings
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from nconv_tpu_torch.data import io, native, png
    from nconv_tpu_torch.runtime import StreamingEngine, benchmark, wires

    out = {}
    f = frames[0]
    rgb_u8, depth = f[0], f[1]
    cap = (H * W // 8 + 511) // 512 * 512
    frame_out = (np.empty((1, H, W, 3), np.uint8), np.empty((1, H, W, 1), np.uint16)) * 2
    cases = {
        "depth_wire": (lambda m: m.encode_depth_wire(depth[None, :, :, None]), 0),
        "frame_dense": (lambda m: m.encode_frame_dense(rgb_u8, depth, f[2], f[3], out=tuple(
            np.empty_like(a) for a in frame_out)), 0),
        "depth_coo": (lambda m: m.encode_depth_coo(depth, cap), 0),
        "yuv420": (lambda m: m.encode_yuv420(rgb_u8), 1),
        "yuv422": (lambda m: m.encode_yuv422(rgb_u8), 1),
    }
    enc = {}
    for name, (fn, steps) in cases.items():
        c, p = fn(native), fn(wires)
        arrays = [(a, b) for a, b in zip(c, p) if isinstance(a, np.ndarray)] if isinstance(c, tuple) else [(c, p)]
        worst = max(int(np.abs(a.astype(np.int64) - b).max()) for a, b in arrays)
        ok = worst <= steps and (name != "depth_coo" or c[2] == p[2])
        enc[name] = dict(c_ms=host_ms(lambda: fn(native)), plain_ms=host_ms(lambda: fn(wires)), max_step=worst)
        log(f"[{'ok' if ok else 'FAIL'}] C encoder {name} against wires.py at {H}x{W}: largest difference "
            f"{worst} step(s) (allowed {steps}); host ms a call (a stream; frame_dense: both), median of {REPS}: "
            f"C {enc[name]['c_ms']:.3f}, "
            f"numpy {enc[name]['plain_ms']:.3f}")
        if not ok:
            raise SystemExit(f"chip_smoke: the C {name} encoder differs from its plain version")
    out["encoders"] = enc

    plain = {n: getattr(wires, n) for n in ("encode_depth_wire", "encode_depth_coo", "encode_yuv420", "encode_yuv422")}
    plain["encode_frame_dense"] = lambda *a, threads=None, **kw: wires.encode_frame_dense(*a, **kw)  # serial
    clocks = {}
    for label, sched, kw in (("f32 dense", "f32", {}), ("mixed dense", "mixed", {}),
                             ("mixed yuv420+coo", "mixed", dict(rgb_wire="yuv420", depth_wire="coo"))):
        fresh_peak()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            eng = StreamingEngine(state, height=H, width=W, compute_dtype=getattr(torch, SCHEDULES[sched]), **kw)
        row = {}
        for encoders in ("plain", "C", "C", "plain"):
            with mock.patch.multiple(native, **plain) if encoders == "plain" else contextlib.nullcontext():
                st = benchmark(eng, n_frames=BENCH_FRAMES, warmup=10, frame_factory=lambda i: frames[i % len(frames)])
            row.setdefault(encoders, []).append({k: st[k].p50_ms for k in ("synced", "e2e")})
        clocks[label] = row
        log(f"    {label}: p50 ms per two-stream frame, runs plain, C, C, plain: "
            + "; ".join(f"{enc_} synced {r['synced']:.3f} e2e {r['e2e']:.3f}"
                        for enc_, rs in (("plain", row["plain"][:1]), ("C", row["C"]), ("plain", row["plain"][1:]))
                        for r in rs))
        del eng
    out["engine_p50"] = clocks

    base = Path(__file__).resolve().parent / "build" / "chip_smoke" / "native"
    base.mkdir(parents=True, exist_ok=True)
    rgb = synthetic_frames(1, seed=3)[0][0]
    decode = {}
    for k, name in enumerate(("none", "sub", "up", "average", "paeth")):
        path = base / f"{name}.png"
        write_png_cycling_filters(path, rgb, filters=(k,))
        c = io.load_rgb(str(path), bgr=False)
        t0 = time.perf_counter()
        with mock.patch.object(native, "unfilter", png._unfilter):
            p = png.read(path).rgb()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ok = np.array_equal(c, p.astype(np.float32)) and np.array_equal(c, rgb.astype(np.float32))
        decode[name] = dict(io_ms=host_ms(lambda: io.load_rgb(str(path)), reps=5), plain_ms=plain_ms)
        log(f"[{'ok' if ok else 'FAIL'}] C PNG reader, a {H}x{W} RGB file with every row filter {name}: bitwise "
            f"the plain decode of png.py and the image written; ms: io.load_rgb (C unfilter and conversion) "
            f"{decode[name]['io_ms']:.2f}, the plain decode {plain_ms:.1f}")
        if not ok:
            raise SystemExit(f"chip_smoke: the C PNG reader differs from png.py on filter {name}")
    cycling = base / "cycling.png"
    write_png_cycling_filters(cycling, rgb)
    read = lambda _=None: io.load_rgb(str(cycling))
    read()
    t0 = time.perf_counter()
    for _ in range(DECODE_FILES):
        read()
    one = DECODE_FILES / (time.perf_counter() - t0)
    with ThreadPoolExecutor(DECODE_THREADS) as pool:
        list(pool.map(read, range(DECODE_THREADS)))
        t0 = time.perf_counter()
        list(pool.map(read, range(DECODE_FILES)))
        many = DECODE_FILES / (time.perf_counter() - t0)
    out["decode"] = dict(by_filter=decode, files_per_s_1=one, files_per_s_threads=many, threads=DECODE_THREADS)
    log(f"    C PNG reader, {DECODE_FILES} reads of a {H}x{W} RGB file (rows through all five filters): "
        f"{one:.1f} files/s on one thread, {many:.1f} on {DECODE_THREADS} ({many / one:.2f}x)")
    return out


def parallel_native_phase(state, frames, throughput_fps):
    """Phase 9: data-parallel training and serving, and the C host data path."""
    t0 = time.perf_counter()
    out = {"training": dp_training(), "engine": dp_engine(state, throughput_fps),
           "native": native_phase(state, frames)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"[ok] phase 9 (parallel and native): {out['wall_s']:.1f} s")
    return out


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
        from nconv_tpu_torch.data import native
        from nconv_tpu_torch.runtime import StreamingEngine, tracing
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 9's world-size-2 group, started by phase 9
        dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0

    # -- 1. environment and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    tracing.enable()
    kernels.lib()
    nvcc_s = sum(s.ms for s in tracing.collected() if s.name == "kernels.build") / 1e3
    tracing.disable()
    tracing.clear()
    log(f"kernel build+load {time.perf_counter() - t0:.1f} s (nvcc {nvcc_s:.1f} s)")
    t0 = time.perf_counter()
    native.lib()  # the host data path (g++), before any timed request encodes with it
    log(f"host library build+load {time.perf_counter() - t0:.1f} s")

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
            eng.forward_staged(eng.stage(*frames[0]))
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
                f"bound {res['bound_ms']:.4f} ({res['bound_by']}) device {res['device_ms']:.4f} "
                f"lib device {_ms(res['library_device_ms'])}"
                + "".join(f" {y[:-3]} {res[y]:.4f}" for y in YARDSTICKS if y in res))
            if not ok:
                failures.append((key, res["err"]))
    if failures:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failures}")
    # per-frame sums beside their yardsticks
    for kname, sched in (("conv_thin", "mixed"), ("conv_chain_tc", "mixed"), ("conv_chain", "f32")):
        mine = [(k, r) for k, r in results.items() if k[0] == kname and k in rec[sched]]
        tot = {f: sum(r[f] * rec[sched][k] for k, r in mine)
               for f in ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms", "library_device_ms", *YARDSTICKS)
               if all(f in r and r[f] is not None
                                                                                         for _, r in mine)}
        log(f"per {sched} frame {kname}: " + ", ".join(f"{f} {v:.4f}" for f, v in tot.items())
            + f"; share of bound {tot['bound_ms'] / tot['ms']:.1%}")

    # -- 3. the main path: two-stream requests through StreamingEngine, each
    # a replay of the frame's CUDA graph; 3b. the wires, run(), throughput
    with torch.no_grad():
        with plain_versions():
            ref = {n: [readings(e, f, e.forward_staged(e.stage(*f))) for f in frames[:2]]
                   for n, e in engines.items()}
            ref64 = {}
            for n, e in engines.items():
                twin = f64_twin(e.model)
                ref64[n] = [readings_f64(e, f, twin) for f in frames[:2]]
                del twin
        del engines
        summary, engine_counts, captured = serve_phase(state, frames, ref, ref64)
        del ref, ref64
        summary["mixed"]["tensor_core_sums"] = tc_breakdown(results, rec["mixed"], summary["mixed"]["benchmark"])
        summary["wires"], wire_results = wire_phase(state, frames, g, results, captured)

    # -- 4. step-1 training
    train_results, train_calls, train_counts, train_summary = train_phase(g)

    # -- 5. guided (step-2) training, f32
    guided_results, guided_calls, guided_counts, guided_summary, carry = guided_phase(g, torch.float32)

    # -- 6. guided training in the mixed schedule, and the residual conv's backward
    bf16_results, bf16_calls, bf16_counts, bf16_summary, _ = guided_phase(g, torch.bfloat16, carry)
    bf16_summary["residual_backward"] = residual_check(g)

    # -- 7. the command line over the port's own data
    reference = dict(f32_frame=summary["f32"]["benchmark"], throughput_fps=summary["wires"]["throughput"]["fps"],
                     step1_ms=train_summary["step_ms"]["kernel"]["p50_ms"],
                     guided_f32_ms=guided_summary["step_ms"]["kernel"]["p50_ms"],
                     guided_bf16_ms=bf16_summary["step_ms"]["kernel"]["p50_ms"])
    cli_summary = cli_phase(reference)

    # -- 8. export and interop: the torch.export program, the ONNX artifact,
    # the export / convert commands
    t_phase = time.perf_counter()
    replay = {n: summary[n]["benchmark"]["device"]["p50_ms"] for n in SCHEDULES}
    export_summary = {"program": export_program_phase(state, replay, smi), "onnx": onnx_phase(state, smi),
                      "commands": interop_cli_phase(state)}
    export_summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[ok] phase 8 (export and interop): {export_summary['wall_s']:.1f} s")

    # -- 9. data parallelism (training over a mesh of ranks, rack serving)
    # and the native host data path (C PNG reader, C wire encoders)
    parallel_summary = parallel_native_phase(state, frames, summary["wires"]["throughput"]["fps"])

    # -- report: one entry per kernel form; sums per two-stream frame over
    # the mixed main path for the serving kernels, per step-1 train step for
    # K2's K x K form and K5, per guided train step for the guided backward
    # forms, per bf16 guided train step for the tensor-core backward forms
    # (launches: the serving run's, and each fit's)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke_calls.json").write_text(json.dumps(
        {"card": smi, "engines": summary, "training": train_summary, "guided_training": guided_summary,
         "guided_training_bf16": bf16_summary, "cli": cli_summary, "export": export_summary,
         "parallel_native": parallel_summary,
         "calls": [{"key": repr(k), **v}
                   for k, v in {**results, **wire_results, **train_results, **guided_results,
                                **bf16_results}.items()]},
        indent=1))
    entries = []
    for kname, (src, replaces) in KERNELS.items():
        if kname in TRAIN_KERNELS:
            per, res, launches = train_calls, train_results, train_counts[kname]
        elif kname in GUIDED_KERNELS:
            per, res, launches = guided_calls, guided_results, guided_counts[kname]
        elif kname in BF16_STEP_KERNELS:
            per, res, launches = bf16_calls, bf16_results, bf16_counts[kname]
        else:  # a serving form: from the mixed frame, or the f32 one if the mixed runs none
            sched = "mixed" if PER_FRAME["mixed"].get(kname) else "f32"
            per, res, launches = rec[sched], results, engine_counts[sched][kname]
        calls = [(k, r) for k, r in res.items() if k in per and k[0] == kname]
        tot = lambda f: sum(r[f] * per[k] for k, r in calls)
        libs = [r["library_ms"] for _, r in calls]
        bound = tot("bound_ms")
        ops_share = sum(r["bound_ms"] * per[k] for k, r in calls if r["bound_by"] == "operations")
        entries.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            dtype="/".join(sorted({r["in_dtype"] for _, r in calls})), launches=launches,
            max_abs_err=max(r["abs_err"] for _, r in calls),
            ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=bound,
            bound_by="operations" if ops_share > bound / 2 else "bytes",
            library_ms=None if any(v is None for v in libs) else tot("library_ms"),
            # graph-replayed sums (library: where every call has one)
            **{f: tot(f) for f in ("device_ms", "library_device_ms") if all(r.get(f) is not None for _, r in calls)},
        ))
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
