"""Device time of ``wgrad_tc`` (``csrc/wgrad_tc.cu``) on each weight-cotangent
call of one bf16 guided train step, for this tree's source, the same source
with text replaced (a variant), and another tree's (``--parent``), side by
side on one card:

    python3 scripts/wgrad_probe.py --parent compare/parent
    python3 scripts/wgrad_probe.py --variant kh4 --variant nolag --trace

Each source is compiled alone with nvcc (``-shared``, the package's flags)
into ``build/wgrad_probe/<name>/`` and called through its C entry on random
bf16 operands of the call's shapes (B = 1 at 352x1216, the parts' layouts as
the step records them); every variant's result is held to the first
source's within 1e-5 (rel RMSE), and each call is timed as 20 launches
captured in a CUDA graph (median of 5 replays). ``--trace`` adds a variant
that stamps ``clock64`` at each tile's acquire / issue / land / publish in
its producer warpgroup and take / release in consumer warpgroup 0 of one
block, and prints that block's timeline for three calls. Built-in variants
(``VARIANTS``) cut or change one part of the kernel; ``--replace
NAME=OLD=>NEW`` adds another. Needs a CUDA device; prints a sum a step for
each source as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

# name: [(old text, new text)] replaced in this tree's wgrad_tc.cu
VARIANTS = {
    "kh4": [("constexpr int KH = 8;", "constexpr int KH = 4;")],  # chains of 4 k16 steps
    "nolag": [("const bool lag = a.stages >= 4;", "const bool lag = false;")],
    "lag3": [("const bool lag = a.stages >= 4;", "const bool lag = a.stages >= 3;")],
    "nogtma": [("a.gtma = ng == 1 && a.gvec[0] && wo % 8 == 0;", "a.gtma = 0;")],  # g by cp.async
    "noxtma": [("a.tma = W % 8 == 0;", "a.tma = 0;")],  # x by cp.async
}
_REC = ("if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 127) == 0 && i < 64) reinterpret_cast<unsigned "
        "long long*>(a.part + (size_t)gridDim.y * a.M * a.KK * a.cin)[%d * 64 + i] = clock64();")
TRACE = [
    ("      ring.acquire(i);", "      ring.acquire(i); " + _REC % 0),
    ("      cp_async_commit();", "      cp_async_commit(); " + _REC % 1),
    ("      hop::named_sync(1 + pw, 128);  // every thread's pieces of tile i have landed",
     "      hop::named_sync(1 + pw, 128); " + _REC % 2),
    ("      ring.publish(i);\n    };", "      ring.publish(i); " + _REC % 3 + "\n    };"),
    ("    ring.take(i);", "    ring.take(i); if (threadIdx.x < 384) { " + _REC % 4 + " }"),
    ("    ring.release(i);  // g read", "    if (threadIdx.x < 384) { " + _REC % 5 + " } ring.release(i);  // g read"),
]
TRACE_CALLS = (6, 11, 16)

# one bf16 guided step's calls at B = 1, 352x1216: (count, x channels as
# parts, x H, W, x channels-last, g channels as parts, k, stride)
CALLS = [
    (1, (1,), 176, 608, False, (64,), 3, 1), (1, (1,), 352, 1216, False, (32,), 3, 1),
    (1, (1,), 44, 152, False, (64,), 3, 1), (1, (1,), 88, 304, False, (64,), 3, 1),
    (1, (3,), 352, 1216, True, (64,), 3, 1), (1, (32,), 176, 608, False, (1,), 3, 1),
    (1, (32,), 176, 608, False, (32,), 3, 1), (2, (32, 32), 352, 1216, False, (32,), 3, 1),
    (1, (32,), 352, 1216, False, (1, 32), 4, 2), (1, (32,), 352, 1216, False, (1,), 3, 1),
    (1, (32,), 352, 1216, False, (128,), 3, 2), (3, (32,), 352, 1216, False, (32,), 3, 1),
    (2, (64, 64), 176, 608, False, (64,), 3, 1), (1, (64,), 176, 608, False, (1, 64), 4, 2),
    (1, (64,), 176, 608, False, (128,), 3, 2), (1, (64,), 176, 608, False, (32,), 3, 1),
    (1, (64,), 176, 608, False, (64,), 3, 1), (1, (64, 64), 44, 152, False, (64,), 3, 1),
    (1, (64,), 44, 152, False, (1,), 3, 1), (3, (64,), 44, 152, False, (64,), 3, 1),
    (2, (64, 64), 88, 304, False, (64,), 3, 1), (1, (64,), 88, 304, False, (1, 64), 4, 2),
    (1, (64,), 88, 304, False, (1,), 3, 1), (1, (64,), 88, 304, False, (128,), 3, 2),
    (3, (64,), 88, 304, False, (64,), 3, 1),
]


def build(sources):
    """{name: (csrc dir, replacements)} -> {name: (library, slices arity)}"""
    from nconv_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    out, procs = {}, {}
    for name, (src_dir, reps) in sources.items():
        d = HERE / "build" / "wgrad_probe" / name
        d.mkdir(parents=True, exist_ok=True)
        text = (src_dir / "wgrad_tc.cu").read_text()
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"wgrad_probe: variant {name}: text not found: {old!r}")
            text = text.replace(old, new)
        for h in src_dir.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "wgrad_tc.cu").write_text(text)
        # older sources' slices query takes no stride
        arity = 7 if "int ksize, int stride) {\n  return nct::wtc::plan" in text else 6
        procs[name] = (arity, subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-shared", str(d / "wgrad_tc.cu"),
                                                "-o", str(d / "w.so")],
                                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (arity, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"wgrad_probe: {name} did not build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(HERE / "build" / "wgrad_probe" / name / "w.so"))
        lib.nct_wgrad_tc.argtypes = [P, P, I, P, P, I, I, I, I, I, I, I, I, I, I, I, P, P, P]
        lib.nct_wgrad_tc_slices.argtypes = [I] * arity
        out[name] = (lib, arity)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another tree whose wgrad_tc.cu is timed first")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--replace", action="append", default=[], help="NAME=OLD=>NEW, a variant of this tree's source")
    ap.add_argument("--trace", action="store_true", help="also a traced variant and one block's timeline")
    args = ap.parse_args()
    import torch

    from nconv_tpu_torch.kernels import CSRC, part_args

    if not torch.cuda.is_available():
        raise SystemExit("wgrad_probe: needs a CUDA device")
    sources = {}
    if args.parent:
        sources["parent"] = (Path(args.parent).resolve() / "nconv_tpu_torch" / "csrc", [])
    sources["tree"] = (CSRC, [])
    for v in args.variant:
        sources[v] = (CSRC, VARIANTS[v])
    for r in args.replace:
        name, rest = r.split("=", 1)
        sources[name] = (CSRC, [tuple(x.split("=>")) for x in rest.split(";;")])
    if args.trace:
        sources["trace"] = (CSRC, TRACE)
    libs = build(sources)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for ci, (count, xc, h, w, last, gc, k, s) in enumerate(CALLS):
        ho, wo = (h + 2 - k) // s + 1, (w + 2 - k) // s + 1

        def make(c, hh, ww, channels_last):
            if channels_last:
                return torch.randn(1, hh, ww, c, generator=g, device="cuda").to(torch.bfloat16).permute(0, 3, 1, 2)
            return torch.randn(1, c, hh, ww, generator=g, device="cuda").to(torch.bfloat16)

        x, gp = [make(c, h, w, last) for c in xc], [make(c, ho, wo, False) for c in gc]
        cin, m = sum(xc), sum(gc)
        xptrs, xmeta = part_args(x, [False] * len(x))
        gptrs, gmeta = part_args(gp, [False] * len(gp))
        ref = None
        for name, (lib, arity) in libs.items():
            sl = lib.nct_wgrad_tc_slices(*((1, ho, wo, m, cin, k, s)[:arity]))
            part = torch.zeros(sl * m * cin * k * k + 1024, device="cuda")
            out = torch.empty((m, cin, k, k), device="cuda")

            def run():
                e = lib.nct_wgrad_tc(gptrs, gmeta, len(gp), xptrs, xmeta, len(x), 1, m, cin, h, w, ho, wo, k, s, 1,
                                     part.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if e:
                    raise SystemExit(f"wgrad_probe: {name} returned {e} on call {ci}")

            run()
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone()
            else:
                err = float((out.double() - ref.double()).norm() / ref.double().norm())
                if err > 1e-5:
                    raise SystemExit(f"wgrad_probe: {name} disagrees on call {ci}: rel {err:.2e}")
            if name == "trace" and ci in TRACE_CALLS:
                tr = part[sl * m * cin * k * k:].view(torch.int64)[:384].view(6, 64).cpu()
                print(f"trace, call {ci}: acquire / issued / landed / published / taken / released, "
                      "clock64 ticks / 1000 from the first acquire")
                for i in range(24):
                    if int(tr[0, i]):
                        print(f"  tile {i:2d} " + " ".join(f"{(int(tr[e, i]) - int(tr[0, 0])) / 1000:8.2f}"
                                                          for e in range(6)))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(20):
                    run()
            graph.replay()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                graph.replay()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / 20)
            res[(ci, name)] = statistics.median(times)
        print(f"x{count} M {m} cin {cin} {h}x{w} k{k} s{s} (us): "
              + " ".join(f"{n} {res[(ci, n)] * 1e3:.1f}" for n in libs), flush=True)
    print(card)
    print("ms a step: " + " ".join(f"{n} {sum(res[(i, n)] * c[0] for i, c in enumerate(CALLS)):.4f}" for n in libs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
