"""Time each launch-plan branch of the f32 CUDA-core kernels against the
tiles it displaces, on the card, at the main path's calls.

    python -m nconv_tpu_torch.runtime.plan_probe [--rounds 5] [--reps 20]

K6's f32 form (``csrc/wgrad.cu``) picks a tile shape (MG, MR) by (M, N);
K2's output-stationary kernel (``convkxk_kernel`` of ``csrc/conv.cu``), in
its backward K x K form and its forward (plain and residual), picks channel
groups (a small grid splits them) and a tile (B-F, H, P) by group width,
form and stride; K3's f32 3x3/s2 form (``csrc/convt.cu``, ``nct::t3``) is
timed against its groups split in two, and its f32 4x4/s2 forward
(``nct::t4``, groups of at most 32 channels) against groups of 64 and
half the rows a block; K5 (``csrc/filtergrad.cu``) picks the dot form
(D) for the 1x1 cout-1 head, else the tiled form at two channels a group
where cin is even, g staged as stored where its rows are whole 16-byte
vectors (else pixel-major) and one wave of blocks, timed against one
channel a group, the other g layout and two waves; K1 (``csrc/nconv.cu``)
picks the direct 1x1 form (D) for an unpooled 1x1, else the tiled form of
its output channels (Q at 8, T at 1); K4's f32 form (``csrc/chain.cu``) a
tile (S, T) by its grid.
This script drives one f32 guided train step (B = 1), one step-1 train
step (B = 4), one f32 and one mixed two-stream frame at KITTI 352x1216
and records every call of the eight kernels. Then, for each distinct
call, it launches each tile the kernel has (and the unsplit groups)
through a probe library that includes the sources unchanged and exports
their ``run`` with a given plan, checks each against the plain version
(1e-5 rel RMSE, each output of K1), and times them with CUDA events:
``rounds`` rounds of ``reps`` launches each, the candidates in a rotating
order, reporting the median round and the spread (max - min) of the
rounds.

Prints a line per call and, per plan branch, the sums over the calls that
take it (times their count per step) of the plan's time and of each
displaced tile's, then one JSON object with all of it as the last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from contextlib import ExitStack
from unittest import mock

import torch

from .. import kernels
from ..ops import convops, nconv
from .profile import _train_step, request

# The probe's own entries: the sources' launch code with a plan given.
_WGRAD_PROBE = r"""
#include "wgrad.cu"
extern "C" int probe_wgrad_tile(int M, int N) {
  const nct::wg::Tile t = nct::wg::tile_of(M, N);
  return 100 * t.mg + t.mr;
}
extern "C" int probe_wgrad_slices(int B, int ho, int wo, int M, int N, int mg, int mr) {
  return nct::wg::plan(B, ho, wo, M, N, {mg, mr}).slices;
}
extern "C" int probe_wgrad(const void* const* g_ptrs, const long long* g_meta, int ng,
                           const void* const* x_ptrs, const long long* x_meta, int nx, int B, int M,
                           int cin, int H, int W, int ho, int wo, int ksize, int stride, int pad,
                           float* part, float* out, int mg, int mr, void* stream) {
  using namespace nct;
  using namespace nct::wg;
  Args a{};
  fill_parts(a.g, g_ptrs, g_meta, ng);
  fill_parts(a.x, x_ptrs, x_meta, nx);
  for (int i = 0; i < ng; ++i) a.gvec[i] = vec_rows<4>(a.g[i]);
  a.ng = ng, a.nx = nx, a.M = M, a.cin = cin, a.H = H, a.W = W, a.ho = ho, a.wo = wo, a.pad = pad;
  a.part = part;
  return run(a, plan(B, ho, wo, M, cin * ksize * ksize, {mg, mr}), ksize, stride, out,
             static_cast<cudaStream_t>(stream));
}
"""

_KXK_PROBE = r"""
#include "conv.cu"
extern "C" int probe_kxk_plan(int B, int ho, int wo, int cout, int stride, int form) {
  const nct::kxk::Plan p = nct::kxk::plan(B, ho, wo, cout, stride, form);
  return 256 * ((cout + p.width - 1) / p.width) + p.tile;
}
extern "C" int probe_kxk_whole(int cout, int stride, int form) {
  const int most = nct::kxk::most_of(form, stride);
  return (cout + most - 1) / most;
}
extern "C" int probe_kxk_tile(int width, int stride, int form) { return nct::kxk::tile_of(width, stride, form); }
extern "C" int probe_kxk_rows(int cout, int groups, int tile) {
  return nct::kxk::plan_of(cout, groups, static_cast<char>(tile)).rows;
}
extern "C" int probe_kxk(const void* const* x_ptr, const long long* x_meta, int B, int H, int W, int cin,
                         int ho, int wo, int cout, int ksize, int stride, int pad, const float* w, void* out,
                         int groups, int tile, void* stream) {
  using namespace nct;
  kxk::Args a{};
  fill_parts(a.parts, x_ptr, x_meta, 1);
  a.nparts = 1, a.vec = stride == 1 && W % 4 == 0 && vec_rows<4>(a.parts[0]);
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo;
  a.cout = cout, a.pad = pad, a.w = w, a.out = static_cast<float*>(out);
  return kxk::run(a, kxk::plan_of(cout, groups, static_cast<char>(tile)), kxk::GRAD, ksize, stride,
                  static_cast<cudaStream_t>(stream));
}
extern "C" int probe_conv3x3(const void* const* part_ptrs, const long long* part_meta, int nparts, int u8, int B,
                             int H, int W, int cin, int ho, int wo, int cout, int stride, const float* w,
                             const float* wsc, const float* bias, void* out, int relu, int groups, int tile,
                             void* stream) {
  using namespace nct;
  kxk::Args a{};
  if (!kxk::forward_args(a, part_ptrs, part_meta, nparts, u8, B, H, W, cin, ho, wo, cout, stride, w, wsc, bias,
                         out, relu))
    return static_cast<int>(cudaErrorInvalidValue);
  return kxk::run(a, kxk::plan_of(cout, groups, static_cast<char>(tile)), wsc ? kxk::FWD_RES : kxk::FWD, 3,
                  stride, static_cast<cudaStream_t>(stream));
}
"""

_CONVT_PROBE = r"""
#include "convt.cu"
extern "C" int probe_t3_plan(int B, int h, int w, int cout) {
  const nct::t3::Plan p = nct::t3::plan(cout);
  return 256 * ((cout + p.width - 1) / p.width) + p.rows;
}
extern "C" int probe_t3(const void* const* x_ptr, const long long* x_meta, int B, int h, int w, int cin, int cout,
                        const float* wt, void* out, int groups, int rows, void* stream) {
  using namespace nct;
  t3::Args a{};
  fill_parts(&a.g, x_ptr, x_meta, 1);
  a.vec = w % 4 == 0 && vec_rows<4>(a.g);
  a.B = B, a.h = h, a.w = w, a.cin = cin, a.cout = cout, a.wt = wt, a.out = static_cast<float*>(out);
  return t3::run(a, t3::plan_of(cout, groups, rows), static_cast<cudaStream_t>(stream));
}
extern "C" int probe_t4_plan(int cout) {
  const nct::t4::Plan p = nct::t4::plan(cout);
  return 256 * ((cout + p.width - 1) / p.width) + p.rows;
}
extern "C" int probe_t4_ns(int cout, int groups) { return nct::t4::plan_of(cout, groups, 1).ns; }
extern "C" int probe_t4(const void* const* part_ptrs, const long long* part_meta, int nparts, int B, int H, int W,
                        int cin, int cout, const float* w, const float* bias, void* out, int relu, int groups, int rows,
                        void* stream) {
  using namespace nct;
  t4::Args a{};
  if (!t4::args_of(a, part_ptrs, part_meta, nparts, B, H, W, cin, cout, w, bias, out, relu))
    return static_cast<int>(cudaErrorInvalidValue);
  return t4::run(a, t4::plan_of(cout, groups, rows), static_cast<cudaStream_t>(stream));
}
"""

_FG_PROBE = r"""
#include "filtergrad.cu"
extern "C" int probe_fg_plan(int B, int cin, int H, int ho, int wo, int cout, int ksize) {
  nct::fg::Plan q;
  return nct::fg::plan(q, B, cin, H, ho, wo, cout, ksize) ? -1 : 65536 * q.pm + 256 * q.p + q.form;
}
extern "C" int probe_fg_slices(int B, int cin, int H, int ho, int wo, int cout, int ksize, int form, int p, int pm,
                               int waves) {
  nct::fg::Plan q;
  const int e = nct::fg::plan_of(q, B, cin, H, ho, wo, cout, ksize, static_cast<char>(form), p, pm, waves);
  return e ? -e : q.slices;
}
extern "C" int probe_fg(const float* x, const float* g, int B, int cin, int H, int W, int cout, int ho, int wo,
                        int ksize, int pad_top, int pad_left, float* part, float* out, int form, int p, int pm,
                        int waves, void* stream) {
  using namespace nct;
  fg::Plan q;
  if (!fg::takes(B, cin, H, W, cout, ho, wo, ksize, pad_top, pad_left)) return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = fg::plan_of(q, B, cin, H, ho, wo, cout, ksize, static_cast<char>(form), p, pm, waves)) return e;
  return fg::run(x, g, B, cin, H, W, cout, ho, wo, ksize, pad_top, pad_left, part, out, q,
                 static_cast<cudaStream_t>(stream));
}
"""

_NCONV_PROBE = r"""
#include "nconv.cu"
extern "C" int probe_nconv_plan(int ksize, int cout, int pool) { return nct::nc::plan(ksize, cout, pool); }
extern "C" int probe_nconv(const void* const* d_ptrs, const void* const* c_ptrs, const long long* part_meta,
                           int nparts, int B, int H, int W, int cin, int ho, int wo, int cout, int ksize, int pad,
                           float eps, const float* w, const float* bias, const float* ksum, float* out, float* conf,
                           float* pout, float* pconf, int form, void* stream) {
  using namespace nct;
  nc::Args a{};
  if (!nc::args_of(a, d_ptrs, c_ptrs, part_meta, nparts, B, H, W, cin, ho, wo, pad, eps, w, bias, ksum, out, conf,
                   pout, pconf))
    return static_cast<int>(cudaErrorInvalidValue);
  return nc::run(a, static_cast<char>(form), ksize, cout, pout != nullptr, static_cast<cudaStream_t>(stream));
}
"""

_CHAIN_PROBE = r"""
#include "chain.cu"
extern "C" int probe_chain_plan(int B, int H, int W, int cmid, int cout) {
  const nct::ch::Plan p = nct::ch::plan(B, H, W, cmid, cout);
  return 256 * p.width + p.tile;
}
extern "C" int probe_chain(const void* x, int B, int H, int W, int cin, int cmid, int cout, const float* w1,
                           const float* b1, const float* w2, const float* b2, void* out, int tile, int width,
                           void* stream) {
  using namespace nct;
  ch::Args a{};
  if (!ch::args_of(a, x, F32, B, H, W, cin, cmid, cout, w1, b1, w2, b2, out))
    return static_cast<int>(cudaErrorInvalidValue);
  return ch::run(a, {static_cast<char>(tile), width}, static_cast<cudaStream_t>(stream));
}
"""

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROBE_SIGNATURES = {
    "probe_wgrad_tile": [I, I],
    "probe_wgrad_slices": [I, I, I, I, I, I, I],
    "probe_wgrad": [P, P, I, P, P, I, I, I, I, I, I, I, I, I, I, I, P, P, I, I, P],
    "probe_kxk_plan": [I, I, I, I, I, I],
    "probe_kxk_whole": [I, I, I],
    "probe_kxk_tile": [I, I, I],
    "probe_kxk_rows": [I, I, I],
    "probe_kxk": [P, P, I, I, I, I, I, I, I, I, I, I, P, P, I, I, P],
    "probe_conv3x3": [P, P, I, I, I, I, I, I, I, I, I, I, P, P, P, P, I, I, I, P],
    "probe_t3_plan": [I, I, I, I],
    "probe_t3": [P, P, I, I, I, I, I, P, P, I, I, P],
    "probe_t4_plan": [I],
    "probe_t4_ns": [I, I],
    "probe_t4": [P, P, I, I, I, I, I, I, P, P, P, I, I, I, P],
    "probe_fg_plan": [I, I, I, I, I, I, I],
    "probe_fg_slices": [I, I, I, I, I, I, I, I, I, I, I],
    "probe_fg": [P, P, I, I, I, I, I, I, I, I, I, I, P, P, I, I, I, I, P],
    "probe_nconv_plan": [I, I, I],
    "probe_nconv": [P, P, P, I, I, I, I, I, I, I, I, I, I, F, P, P, P, P, P, P, P, I, P],
    "probe_chain_plan": [I, I, I, I, I],
    "probe_chain": [P, I, I, I, I, I, I, P, P, P, P, P, I, I, P],
}
CHAIN_TILES = "ST"
WGRAD_TILES = [(8, 8), (8, 5), (4, 8), (1, 1), (16, 2)]
GRAD, FWD, FWD_RES = 0, 1, 2  # conv.cu's kxk::Form
# the tiles each form of the output-stationary kernel is built with, by stride
KXK_TILES = {(GRAD, 1): "BCDP", (GRAD, 2): "CE", (FWD, 1): "BCDHP", (FWD, 2): "BCDF", (FWD_RES, 1): "BCD",
             (FWD_RES, 2): "BCD"}
BAR = 1e-5
NO_FIT = 9  # cudaErrorInvalidConfiguration: the tile's stages exceed a block's shared memory at this form


class _NoFit(Exception):
    pass


def nconv_forms(k, cout, pool_out):
    """K1's forms at (k, cout, pool_out): the tiled form of the output
    channels (Q at 8, T at 1), and the direct form (D) for an unpooled 1x1."""
    return ["Q" if cout == 8 else "T"] + (["D"] if k == 1 and not pool_out else [])


def _check(code, what):
    if code == NO_FIT:
        raise _NoFit(what)
    if code:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _start_build():
    """nvcc for the six probe sources, started now; returns a function that
    waits for them, links and loads the library."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    objs, procs = [], []
    for name, text in (("probe_wgrad", _WGRAD_PROBE), ("probe_kxk", _KXK_PROBE), ("probe_convt", _CONVT_PROBE),
                       ("probe_fg", _FG_PROBE),
                       ("probe_nconv", _NCONV_PROBE), ("probe_chain", _CHAIN_PROBE)):
        src = kernels.BUILD_DIR / f"{name}.cu"
        src.write_text(text)
        obj = src.with_suffix(".o")
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}", "-c", str(src), "-o",
                                       str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def finish():
        for p in procs:
            out, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"probe nvcc failed:\n{out}")
        so = kernels.BUILD_DIR / "libplan_probe.so"
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(so)], check=True)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _PROBE_SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        return lib

    return finish


def _sig(t):
    return tuple(t.shape), tuple(t.stride())


def _record_calls():
    """Every K6 f32, K x K f32, K2 f32 forward, 3x3/s2 f32, 4x4/s2 f32
    forward, K5, K1 and K4 f32 call of one guided f32 step, one step-1
    step, one f32 frame and one mixed frame: {(kind, step, key): [count,
    args]}, args the first call's tensors."""
    calls = {}
    step_name = []

    def note(kind, key, args):
        entry = calls.setdefault((kind, step_name[-1]) + key, [0, args])
        entry[0] += 1

    real_wg, real_kx = convops._wgrad_kernel, convops._conv_kxk_kernel
    real_cv, real_t3 = convops._conv3x3_kernel, convops._conv_transpose3x3s2_kernel
    real_nc, real_ch = nconv._nconv2d_kernel, convops._chain_kernel
    real_t4, real_fg = convops._conv_transpose_kernel, convops._filtergrad_kernel

    def wg(x_parts, g_parts, ksize, stride, padding):
        note("wgrad", (tuple(map(_sig, x_parts)), tuple(map(_sig, g_parts)), ksize, stride, padding),
             (x_parts, g_parts, ksize, stride, padding))
        return real_wg(x_parts, g_parts, ksize, stride, padding)

    def kx(x, weight, padding, stride):
        note("conv_kxk" if stride == 1 else "conv4x4s2", (_sig(x), _sig(weight), padding, stride),
             (x, weight, padding, stride))
        return real_kx(x, weight, padding, stride)

    def cv(parts, weight, bias, stride, relu, shortcut, out_dtype):
        if out_dtype == torch.float32:
            note("conv", (tuple(map(_sig, parts)), _sig(weight), bias is None, stride, relu, shortcut is None),
                 (parts, weight, bias, stride, relu, shortcut))
        return real_cv(parts, weight, bias, stride, relu, shortcut, out_dtype)

    def t3(cot, weight):
        note("t3", (_sig(cot), _sig(weight)), (cot, weight))
        return real_t3(cot, weight)

    def nc(d, c, w, b, padding, up2, crop, pool_out, eps):
        note("nconv", (tuple(map(_sig, d)), tuple(up2), _sig(w), padding, crop, pool_out),
             (d, c, w, b, padding, up2, crop, pool_out, eps))
        return real_nc(d, c, w, b, padding, up2, crop, pool_out, eps)

    def ch(x, w1, b1, w2, b2):
        note("chain", (_sig(x), _sig(w1), _sig(w2)), (x, w1, b1, w2, b2))
        return real_ch(x, w1, b1, w2, b2)

    def t4(parts, weight, bias, relu):
        note("t4", (tuple(map(_sig, parts)), _sig(weight), bias is None, relu), (parts, weight, bias, relu))
        return real_t4(parts, weight, bias, relu)

    def fg(x, g, ksize, padding, pad_top):
        note("fg", (_sig(x), _sig(g), ksize, padding, pad_top), (x, g, ksize, padding, pad_top))
        return real_fg(x, g, ksize, padding, pad_top)

    for name, run in (("guided", lambda: _train_step("guided", torch.float32, 352, 1216)),
                      ("step1", lambda: _train_step("unguided", torch.float32, 352, 1216)),
                      ("frame", lambda: request(torch.float32, 352, 1216)),
                      ("mixed", lambda: request(torch.bfloat16, 352, 1216))):
        step_name.append(name)
        step = run()
        step()  # warm-up: builds the kernel library, settles the allocator
        torch.cuda.synchronize()
        with ExitStack() as stack:
            for attr, fn in (("_wgrad_kernel", wg), ("_conv_kxk_kernel", kx), ("_conv3x3_kernel", cv),
                             ("_conv_transpose3x3s2_kernel", t3), ("_chain_kernel", ch),
                             ("_conv_transpose_kernel", t4), ("_filtergrad_kernel", fg)):
                stack.enter_context(mock.patch.object(convops, attr, fn))
            stack.enter_context(mock.patch.object(nconv, "_nconv2d_kernel", nc))
            step()
        torch.cuda.synchronize()
    return calls


def _time(fns, rounds, reps):
    """Per candidate: (median ms a launch over the rounds, spread of the
    rounds in ms); candidates in a rotating order each round."""
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in fns]
    per = [[] for _ in fns]
    for r in range(rounds):
        order = [(i + r) % len(fns) for i in range(len(fns))]
        for i in order:
            fns[i]()  # its own warm-up launch
            ev[i][0].record()
            for _ in range(reps):
                fns[i]()
            ev[i][1].record()
            torch.cuda.synchronize()
            per[i].append(ev[i][0].elapsed_time(ev[i][1]) / reps)
    return [(statistics.median(p), max(p) - min(p)) for p in per]


def _rel(a, b):
    if isinstance(a, tuple):  # K1's outputs, each held to the bar
        return max(map(_rel, a, b))
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _wgrad_candidates(lib, args):
    x_parts, g_parts, ksize, stride, padding = args
    b, h, w, ho, wo, cin, m = convops._check_wgrad(x_parts, g_parts, ksize, stride, padding, torch.float32, "K6")
    n = cin * ksize * ksize
    plan = divmod(lib.probe_wgrad_tile(m, n), 100)
    gptrs, gmeta = kernels.part_args(g_parts, [False] * len(g_parts))
    xptrs, xmeta = kernels.part_args(x_parts, [False] * len(x_parts))
    stream = kernels.stream_of(x_parts[0])
    cands = []
    for mg, mr in WGRAD_TILES:
        part = torch.empty((lib.probe_wgrad_slices(b, ho, wo, m, n, mg, mr), m, n), device="cuda")
        out = torch.empty((m, cin, ksize, ksize), device="cuda")

        def fn(part=part, out=out, mg=mg, mr=mr):
            code = lib.probe_wgrad(gptrs, gmeta, len(g_parts), xptrs, xmeta, len(x_parts), b, m, cin, h, w, ho,
                                   wo, ksize, stride, padding, part.data_ptr(), out.data_ptr(), mg, mr, stream)
            _check(code, f"probe_wgrad ({mg}, {mr})")
            return out
        cands.append((f"({mg},{mr})", fn))
    want = lambda: convops.conv2d_weight_grad_plain(x_parts, g_parts, ksize, padding, stride=stride)
    return f"({plan[0]},{plan[1]})", cands, want, f"[{m}, {cin}, {ksize}, {ksize}] at {ho}x{wo} B={b}"


def _tile_candidates(lib, cout, stride, form, b, ho, wo, launch):
    """The output-stationary kernel's candidates for one call: the plan,
    every other tile the form has at the plan's groups, and the unsplit
    groups where a small grid split them; (plan name, [(name, fn)])."""
    code = lib.probe_kxk_plan(b, ho, wo, cout, stride, form)
    groups, tile = code // 256, chr(code % 256)
    whole = lib.probe_kxk_whole(cout, stride, form)
    options = [(groups, tile)] + [(groups, t) for t in KXK_TILES[form, stride] if t != tile]
    if whole != groups:  # the small grid's split against the unsplit groups
        options.append((whole, chr(lib.probe_kxk_tile(-(-cout // whole), stride, form))))
    cands = []
    for gr, t in options:
        if lib.probe_kxk_rows(cout, gr, ord(t)) < 1:
            continue  # more slabs than warps: not a shape this tile takes
        cands.append((f"{t}/{gr}g", launch(gr, t)))
    return f"{tile}/{groups}g", cands


def _kxk_candidates(lib, args):
    x, weight, padding, stride = args
    b, cin, h, w = x.shape
    cout, k = weight.shape[1 if stride == 1 else 0], weight.shape[-1]
    ho, wo = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
    ptrs, meta = kernels.part_args([x], [False])
    stream = kernels.stream_of(x)
    wc = weight.detach().float().contiguous()

    def launch(gr, t):
        out = torch.empty((b, cout, ho, wo), device="cuda")

        def fn():
            code = lib.probe_kxk(ptrs, meta, b, h, w, cin, ho, wo, cout, k, stride, padding, wc.data_ptr(),
                                 out.data_ptr(), gr, ord(t), stream)
            _check(code, f"probe_kxk ({gr}, {t})")
            return out
        return fn
    plan, cands = _tile_candidates(lib, cout, stride, GRAD, b, ho, wo, launch)
    w_kxk = weight.flip(2, 3).transpose(0, 1) if stride == 1 else weight
    want = lambda: convops.conv2d(x, w_kxk, stride=stride, padding=padding)
    return plan, cands, want, f"[{b}, {cout}, {ho}, {wo}] from {cin} k{k} s{stride}"


def _conv_candidates(lib, args):
    parts, weight, bias, stride, relu, shortcut = args
    b, _, h, w = parts[0].shape
    cout, cin = weight.shape[:2]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    form = FWD if shortcut is None else FWD_RES
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    stream = kernels.stream_of(parts[0])
    wc, bc = weight.detach().float().contiguous(), None if bias is None else bias.detach().float().contiguous()
    sc = None if shortcut is None else shortcut.detach().float().contiguous()
    u8 = int(parts[0].dtype == torch.uint8)

    def launch(gr, t):
        out = torch.empty((b, cout, ho, wo), device="cuda")

        def fn():
            code = lib.probe_conv3x3(ptrs, meta, len(parts), u8, b, h, w, cin, ho, wo, cout, stride,
                                     wc.data_ptr(), None if sc is None else sc.data_ptr(),
                                     None if bc is None else bc.data_ptr(), out.data_ptr(), int(relu), gr, ord(t),
                                     stream)
            _check(code, f"probe_conv3x3 ({gr}, {t})")
            return out
        return fn
    plan, cands = _tile_candidates(lib, cout, stride, form, b, ho, wo, launch)
    want = lambda: convops.conv3x3_plain(parts, weight, bias, stride=stride, relu=relu, shortcut=shortcut,
                                         out_dtype=torch.float32)
    label = f"[{b}, {cout}, {ho}, {wo}] from {cin} s{stride}{' res' if shortcut is not None else ''}"
    return plan, cands, want, label


def _t3_candidates(lib, args):
    cot, weight = args
    b, cin, h, w = cot.shape
    cout = weight.shape[1]
    code = lib.probe_t3_plan(b, h, w, cout)
    groups, rows = code // 256, code % 256
    ptrs, meta = kernels.part_args([cot], [False])
    stream = kernels.stream_of(cot)
    wc = weight.detach().float().contiguous()
    # the plan, and its groups split in two (blocks of half the warps), which lost and went
    options = [(groups, rows)] + ([(2 * groups, rows)] if -(-cout // (2 * groups)) >= 16 else [])
    cands = []
    for gr, r in options:
        out = torch.empty((b, cout, 2 * h, 2 * w), device="cuda")

        def fn(out=out, gr=gr, r=r):
            code = lib.probe_t3(ptrs, meta, b, h, w, cin, cout, wc.data_ptr(), out.data_ptr(), gr, r, stream)
            _check(code, f"probe_t3 ({gr}, {r})")
            return out
        cands.append((f"T/{gr}g", fn))
    want = lambda: convops.conv3x3s2_input_grad_plain(cot, weight)
    return f"T/{groups}g", cands, want, f"[{b}, {cout}, {2 * h}, {2 * w}] from {cin}"


def _t4_candidates(lib, args):
    parts, weight, bias, relu = args
    b, h, w = convops._check_same_geometry(parts)
    cin, cout = weight.shape[:2]
    code = lib.probe_t4_plan(cout)
    groups, rows = code // 256, code % 256
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    stream = kernels.stream_of(parts[0])
    wc, bc = weight.detach().float().contiguous(), None if bias is None else bias.detach().float().contiguous()
    # the plan, groups of 64 (x staged once), and half the rows a block
    options = [(groups, rows)]
    for gr in (groups, -(-cout // 64)):
        ns = lib.probe_t4_ns(cout, gr)
        for r in (8 // ns, 4 // ns):
            if r >= 1 and (gr, r) not in options:
                options.append((gr, r))
    cands = []
    for gr, r in options:
        out = torch.empty((b, cout, 2 * h, 2 * w), device="cuda")

        def fn(out=out, gr=gr, r=r):
            code = lib.probe_t4(ptrs, meta, len(parts), b, h, w, cin, cout, wc.data_ptr(),
                                None if bc is None else bc.data_ptr(), out.data_ptr(), int(relu), gr, r, stream)
            _check(code, f"probe_t4 ({gr}, {r})")
            return out
        cands.append((f"{gr}g/{r}r", fn))
    want = lambda: convops.conv_transpose4x4s2_plain(parts, weight, bias, relu=relu)
    return f"{groups}g/{rows}r", cands, want, f"[{b}, {cout}, {2 * h}, {2 * w}] from {cin}"


def fg_branches(k, cin, cout):
    """K5's branches at (k, cin, cout): (form, channels a group, g
    pixel-major, waves of blocks). The tiled form T at one and (even cin)
    two channels a group, g pixel-major and (cout 8) as stored, at one and
    two waves; at the 1x1 cout-1 head also the dot form D."""
    ps = (1, 2) if cin % 2 == 0 else (1,)
    pms = (1, 0) if cout == 8 else (0,)
    out = [("T", p, pm, w) for p in ps for pm in pms for w in (1, 2)]
    return out + ([("D", 0, 0, 1)] if k == 1 and cout == 1 else [])


def fg_name(form, p, pm, waves):
    return f"{form}{p}{'p' * pm}/w{waves}"


def _fg_candidates(lib, args):
    x, g, ksize, padding, pad_top = args
    b, cin, h, w = x.shape
    cout, ho, wo = g.shape[1:]
    code = lib.probe_fg_plan(b, cin, h, ho, wo, cout, ksize)
    plan = (chr(code % 256), code // 256 % 256, code // 65536 if cout == 8 else 0, 1)
    # the recorded operands' weight cotangents cancel (a normalized conv's
    # scale invariance), so the candidates run on random ones of their shapes
    gen = torch.Generator(device="cuda").manual_seed(cin + 10 * ksize)
    xc, gc = (torch.randn(t.shape, generator=gen, device="cuda") for t in (x, g))
    stream = kernels.stream_of(x)
    cands = []
    for form, p, pm, waves in fg_branches(ksize, cin, cout):
        slices = lib.probe_fg_slices(b, cin, h, ho, wo, cout, ksize, ord(form), p, pm, waves)
        part = torch.empty((slices, cout * cin * ksize * ksize), device="cuda")
        out = torch.empty((cout, cin, ksize, ksize), device="cuda")

        def fn(part=part, out=out, form=form, p=p, pm=pm, waves=waves):
            code = lib.probe_fg(xc.data_ptr(), gc.data_ptr(), b, cin, h, w, cout, ho, wo, ksize, pad_top, padding,
                                part.data_ptr(), out.data_ptr(), ord(form), p, pm, waves, stream)
            _check(code, f"probe_fg ({form}, {p}, {pm}, {waves})")
            return out
        cands.append((fg_name(form, p, pm, waves), fn))
    want = lambda: convops.conv2d_weight_grad_plain(xc, gc, ksize, padding, pad_top)
    return fg_name(*plan), cands, want, f"[{cout}, {cin}, {ksize}, {ksize}] at {ho}x{wo} B={b}"


def _nconv_candidates(lib, args):
    d, c, weight, bias, padding, up2, crop, pool_out, eps = args
    b, h, w = nconv._check_parts(d, c, up2)
    cout, cin, k, _ = weight.shape
    ho, wo = h + 2 * padding - k + 1 - 2 * crop, w + 2 * padding - k + 1 - 2 * crop
    plan = chr(lib.probe_nconv_plan(k, cout, int(pool_out)))
    w32, b32 = weight.detach().float().contiguous(), bias.detach().float().contiguous()
    ksum = w32.sum(dim=(1, 2, 3)).contiguous()
    dptrs, meta = kernels.part_args(d, up2)
    cptrs, _ = kernels.part_args(c, up2)
    stream = kernels.stream_of(d[0])
    cands = []
    for form in nconv_forms(k, cout, pool_out):
        outs = [torch.empty((b, cout, ho, wo), device="cuda") for _ in range(2)]
        outs += [torch.empty((b, cout, ho // 2, wo // 2), device="cuda") for _ in range(2 if pool_out else 0)]

        def fn(outs=outs, form=form):
            ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
            code = lib.probe_nconv(dptrs, cptrs, meta, len(d), b, h, w, cin, ho, wo, cout, k, padding - crop, eps,
                                   w32.data_ptr(), b32.data_ptr(), ksum.data_ptr(), *ptrs, ord(form), stream)
            _check(code, f"probe_nconv ({form})")
            return tuple(outs)
        cands.append((form, fn))
    want = lambda: nconv.nconv2d_fused_plain(d, c, weight, bias, padding=padding, up2=up2, crop=crop,
                                             pool_out=pool_out, eps=eps)
    label = f"[{b}, {cout}, {ho}, {wo}] from {cin} k{k}{' pool' if pool_out else ''}{' up2' if any(up2) else ''}"
    return plan, cands, want, label


def _chain_candidates(lib, args):
    x, w1, b1, w2, b2 = args
    b, cin, h, w = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    code = lib.probe_chain_plan(b, h, w, cmid, cout)
    width, tile = code // 256, chr(code % 256)
    ws = [t.detach().float().contiguous() for t in (w1, b1, w2, b2)]
    stream = kernels.stream_of(x)
    cands = []
    for t in CHAIN_TILES:
        out = torch.empty((b, cout, h, w), device="cuda")

        def fn(out=out, t=t):
            code = lib.probe_chain(x.data_ptr(), b, h, w, cin, cmid, cout, *(v.data_ptr() for v in ws),
                                   out.data_ptr(), ord(t), width, stream)
            _check(code, f"probe_chain ({t}, {width})")
            return out
        cands.append((f"{t}/{width}", fn))
    want = lambda: convops.conv3x3_chain2_plain(x, w1, b1, w2, b2)
    return f"{tile}/{width}", cands, want, f"[{b}, {cin}->{cmid}->{cout}, {h}, {w}]"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("plan_probe: needs a CUDA device")
    finish = _start_build()
    calls = _record_calls()
    lib = finish()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    rows = []
    with torch.no_grad(), kernels.exact_f32(torch.empty(0, device="cuda")):
        for key, (count, cargs) in calls.items():
            kind, step = key[:2]
            plan, cands, want, label = {"wgrad": _wgrad_candidates, "conv": _conv_candidates,
                                        "t3": _t3_candidates, "nconv": _nconv_candidates,
                                        "chain": _chain_candidates, "t4": _t4_candidates,
                                        "fg": _fg_candidates}.get(kind, _kxk_candidates)(lib, cargs)
            ref = want()
            errs = {}
            for name, fn in list(cands):
                try:
                    errs[name] = _rel(fn(), ref)
                except _NoFit:  # not a shape this tile takes
                    cands.remove((name, fn))
            bad = {n: e for n, e in errs.items() if not e <= BAR}
            if bad:
                raise SystemExit(f"plan_probe: {kind} {label}: candidates off their plain version: {bad}")
            times = dict(zip([n for n, _ in cands], _time([fn for _, fn in cands], args.rounds, args.reps)))
            row = {"kernel": kind, "step": step, "call": label, "count": count, "plan": plan,
                   "ms": {n: t[0] for n, t in times.items()}, "spread": {n: t[1] for n, t in times.items()}}
            rows.append(row)
            best = min(row["ms"], key=row["ms"].get)
            print(f"{kind:10s} {step:6s} {label:44s} x{count} plan {plan:8s} "
                  + " ".join(f"{n} {row['ms'][n]:.4f}±{row['spread'][n]:.4f}" for n in row["ms"])
                  + f"  best {best}")
    summary = _branches(rows)
    for s in summary:
        print(f"branch {s['kernel']} {s['branch']}: {s['calls']} calls; plan ms {s['plan_ms']:.4f} "
              f"(spread {s['plan_spread']:.4f}); "
              + "; ".join(f"{n} {v['ms']:.4f} (spread {v['spread']:.4f})" for n, v in s["displaced"].items()))
    result = {"card": card, "rounds": args.rounds, "reps": args.reps, "calls": rows, "branches": summary}
    print(json.dumps(result))
    return result


def _branches(rows):
    """Per kernel and plan branch: the step-weighted sums of the plan's time
    and of each other candidate's over the calls that take the branch (only
    candidates every such call has)."""
    groups = {}
    for r in rows:
        kernel = {"conv": "fwd"}.get(r["kernel"], r["kernel"])
        branch = r["plan"]
        if kernel in ("nconv", "chain", "t4", "fg"):  # by path: the paths' calls differ in batch and in form
            branch = f"{branch} ({r['step']})"
        elif kernel != "wgrad":  # candidates named tile/groups: the tile and whether the plan split its groups
            tile, g = r["plan"].split("/")
            unsplit = [n for n in r["ms"] if not n.endswith(f"/{g}")]
            form = (" s2" if " s2" in r["call"] else "") + (" res" if r["call"].endswith(" res") else "")
            branch = tile + form + (" split" if unsplit and kernel != "t3" else "") + f" ({r['step']})"
        groups.setdefault((kernel, branch), []).append(r)
    out = []
    for (kernel, branch), rs in groups.items():
        disp = {}
        if kernel in ("wgrad", "nconv", "chain", "t4", "fg"):
            names = set.intersection(*(set(r["ms"]) - {r["plan"]} for r in rs))
            for n in sorted(names):
                disp[n] = {"ms": sum(r["count"] * r["ms"][n] for r in rs),
                           "spread": sum(r["count"] * r["spread"][n] for r in rs)}
        else:  # sum by tile letter and by the unsplit groups
            for r in rs:
                g = r["plan"].split("/")[1]
                for n in r["ms"]:
                    if n == r["plan"]:
                        continue
                    label = n.split("/")[0] if n.endswith(f"/{g}") else "split" if kernel == "t3" else "unsplit"
                    d = disp.setdefault(label, {"ms": 0.0, "spread": 0.0, "calls": 0})
                    d["ms"] += r["count"] * r["ms"][n]
                    d["spread"] += r["count"] * r["spread"][n]
                    d["calls"] += r["count"]
            n_calls = sum(r["count"] for r in rs)
            disp = {k: v for k, v in disp.items() if v.pop("calls") == n_calls}
        out.append({"kernel": kernel, "branch": branch, "calls": sum(r["count"] for r in rs),
                    "plan_ms": sum(r["count"] * r["ms"][r["plan"]] for r in rs),
                    "plan_spread": sum(r["count"] * r["spread"][r["plan"]] for r in rs), "displaced": disp})
    return out


if __name__ == "__main__":
    main()
