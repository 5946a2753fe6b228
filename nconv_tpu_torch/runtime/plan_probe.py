"""Time each launch-plan branch of the f32 backward's two CUDA-core kernels
against the tiles it displaces, on the card, at the main path's calls.

    python -m nconv_tpu_torch.runtime.plan_probe [--rounds 5] [--reps 20]

K6's f32 form (``csrc/wgrad.cu``) picks a tile shape (MG, MR) by (M, N);
K2's f32 K x K form (``convkxk_kernel`` of ``csrc/conv.cu``) picks channel
groups (a small grid splits them) and a tile B-E by group width. This
script drives one f32 guided train step (B = 1) and one step-1 train step
(B = 4) at KITTI 352x1216 and records every call of the two kernels. Then,
for each distinct call, it launches each tile the kernel has (and, for the
K x K form, the unsplit groups) through a probe library that includes the
two sources unchanged and exports their ``run`` with a given plan, checks
each against the plain version (1e-5 rel RMSE), and times them with CUDA
events: ``rounds`` rounds of ``reps`` launches each, the candidates in a
rotating order, reporting the median round and the spread (max - min) of
the rounds.

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
from ..ops import convops
from .profile import _train_step

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
extern "C" int probe_kxk_groups(int B, int ho, int wo, int cout, int stride) {
  return nct::kxk::groups_of(B, ho, wo, cout, stride);
}
extern "C" int probe_kxk_tile(int width, int stride) { return nct::kxk::tile_of(width, stride); }
extern "C" int probe_kxk_rows(int cout, int groups, int tile) {
  return nct::kxk::plan_of(cout, groups, static_cast<char>(tile)).rows;
}
extern "C" int probe_kxk(const void* const* x_ptr, const long long* x_meta, int B, int H, int W, int cin,
                         int ho, int wo, int cout, int ksize, int stride, int pad, const float* w, void* out,
                         int groups, int tile, void* stream) {
  using namespace nct;
  kxk::Args a{};
  fill_parts(&a.x, x_ptr, x_meta, 1);
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo;
  a.cout = cout, a.pad = pad, a.w = w, a.out = static_cast<float*>(out);
  return kxk::run(a, kxk::plan_of(cout, groups, static_cast<char>(tile)), ksize, stride,
                  static_cast<cudaStream_t>(stream));
}
"""

P, I = ctypes.c_void_p, ctypes.c_int
_PROBE_SIGNATURES = {
    "probe_wgrad_tile": [I, I],
    "probe_wgrad_slices": [I, I, I, I, I, I, I],
    "probe_wgrad": [P, P, I, P, P, I, I, I, I, I, I, I, I, I, I, I, P, P, I, I, P],
    "probe_kxk_groups": [I, I, I, I, I],
    "probe_kxk_tile": [I, I],
    "probe_kxk_rows": [I, I, I],
    "probe_kxk": [P, P, I, I, I, I, I, I, I, I, I, I, P, P, I, I, P],
}
WGRAD_TILES = [(8, 8), (8, 5), (4, 8), (1, 1), (16, 2)]
KXK_TILES = {1: "BCD", 2: "CE"}
BAR = 1e-5
NO_FIT = 9  # cudaErrorInvalidConfiguration: the tile's stages exceed a block's shared memory at this form


class _NoFit(Exception):
    pass


def _check(code, what):
    if code == NO_FIT:
        raise _NoFit(what)
    if code:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _start_build():
    """nvcc for the two probe sources, started now; returns a function that
    waits for them, links and loads the library."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    objs, procs = [], []
    for name, text in (("probe_wgrad", _WGRAD_PROBE), ("probe_kxk", _KXK_PROBE)):
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
    """Every K6 f32 and K x K f32 call of one guided f32 step and one step-1
    step: {(kind, step, key): [count, args]}, args the first call's tensors."""
    calls = {}
    step_name = []

    def note(kind, key, args):
        entry = calls.setdefault((kind, step_name[-1]) + key, [0, args])
        entry[0] += 1

    real_wg, real_kx = convops._wgrad_kernel, convops._conv_kxk_kernel

    def wg(x_parts, g_parts, ksize, stride, padding):
        note("wgrad", (tuple(map(_sig, x_parts)), tuple(map(_sig, g_parts)), ksize, stride, padding),
             (x_parts, g_parts, ksize, stride, padding))
        return real_wg(x_parts, g_parts, ksize, stride, padding)

    def kx(x, weight, padding, stride):
        note("conv_kxk" if stride == 1 else "conv4x4s2", (_sig(x), _sig(weight), padding, stride),
             (x, weight, padding, stride))
        return real_kx(x, weight, padding, stride)

    for kind, name in (("guided", "guided"), ("unguided", "step1")):
        step_name.append(name)
        step = _train_step(kind, torch.float32, 352, 1216)
        step()  # warm-up: builds the kernel library, settles the allocator
        torch.cuda.synchronize()
        with ExitStack() as stack:
            stack.enter_context(mock.patch.object(convops, "_wgrad_kernel", wg))
            stack.enter_context(mock.patch.object(convops, "_conv_kxk_kernel", kx))
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


def _kxk_candidates(lib, args):
    x, weight, padding, stride = args
    b, cin, h, w = x.shape
    cout, k = weight.shape[1 if stride == 1 else 0], weight.shape[-1]
    ho, wo = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
    groups = lib.probe_kxk_groups(b, ho, wo, cout, stride)
    most = 48 if stride == 2 else 128
    whole = -(-cout // most)
    plan = (groups, chr(lib.probe_kxk_tile(-(-cout // groups), stride)))
    ptrs, meta = kernels.part_args([x], [False])
    stream = kernels.stream_of(x)
    wc = weight.detach().float().contiguous()
    options = [(groups, t) for t in KXK_TILES[stride]]
    if whole != groups:  # the small grid's split against the unsplit groups
        options.append((whole, chr(lib.probe_kxk_tile(-(-cout // whole), stride))))
    cands = []
    for gr, t in options:
        if lib.probe_kxk_rows(cout, gr, ord(t)) < 1:
            continue  # more slabs than warps: not a shape this tile takes
        out = torch.empty((b, cout, ho, wo), device="cuda")

        def fn(out=out, gr=gr, t=t):
            code = lib.probe_kxk(ptrs, meta, b, h, w, cin, ho, wo, cout, k, stride, padding, wc.data_ptr(),
                                 out.data_ptr(), gr, ord(t), stream)
            _check(code, f"probe_kxk ({gr}, {t})")
            return out
        cands.append((f"{t}/{gr}g", fn))
    w_kxk = weight.flip(2, 3).transpose(0, 1) if stride == 1 else weight
    want = lambda: convops.conv2d(x, w_kxk, stride=stride, padding=padding)
    return f"{plan[1]}/{plan[0]}g", cands, want, f"[{b}, {cout}, {ho}, {wo}] from {cin} k{k} s{stride}"


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
            plan, cands, want, label = (_wgrad_candidates if kind == "wgrad" else _kxk_candidates)(lib, cargs)
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
            print(f"{kind:10s} {step:6s} {label:40s} x{count} plan {plan:8s} "
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
        kernel = "wgrad" if r["kernel"] == "wgrad" else "kxk"
        branch = r["plan"]
        if kernel == "kxk":
            tile, g = r["plan"].split("/")
            unsplit = [n for n in r["ms"] if not n.endswith(f"/{g}")]
            branch = tile + (" split" if unsplit else "") + f" ({r['step']})"
        groups.setdefault((kernel, branch), []).append(r)
    out = []
    for (kernel, branch), rs in groups.items():
        names = set.intersection(*(set(r["ms"]) - {r["plan"]} for r in rs)) if kernel == "wgrad" else None
        disp = {}
        if kernel == "wgrad":
            for n in sorted(names):
                disp[n] = {"ms": sum(r["count"] * r["ms"][n] for r in rs),
                           "spread": sum(r["count"] * r["spread"][n] for r in rs)}
        else:  # K x K candidates are named tile/groups; sum by tile letter and by the unsplit groups
            for r in rs:
                g = r["plan"].split("/")[1]
                for n in r["ms"]:
                    if n == r["plan"]:
                        continue
                    label = "unsplit" if not n.endswith(f"/{g}") else n.split("/")[0]
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
