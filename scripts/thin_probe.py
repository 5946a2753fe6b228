"""Device time of ``conv_thin`` (``csrc/conv_thin.cu``) on its nine main-path
calls and of the bf16 3x3/s2 input cotangent (mode 3 of ``csrc/conv_tc.cu``)
on its three, for this tree's sources, the same sources with text replaced
(variants), and another tree's (``--parent``), side by side on one card:

    python3 scripts/thin_probe.py --parent compare/parent
    python3 scripts/thin_probe.py --kernel thin --trace \
        --replace tr8="constexpr int TX = 64, TR = 4,=>constexpr int TX = 64, TR = 8,"

Each source is compiled alone with nvcc (``-shared``, the package's flags)
into ``build/thin_probe/<name>/`` and called through its C entry on random
operands of the call's shapes: the mixed frame's u8 encoder ([2, 352, 1216,
3] NHWC -> 32, the residual form) and its four heads at B = 2, the bf16
guided step's heads at B = 1 (32-64 bf16 channels -> 1, bias), and the
step's three T3 calls (cotangent [1, 128, h, w] against [128, cout, 3, 3]
whose last 64 rows are centre-only, passed as such where the source's entry
takes the count). Every variant's output is held to the first source's
within 5e-3 (rel RMSE, the bf16 bar; a diagnostic variant that cuts
work out is reported, not stopped), and each call is timed as 20 launches
captured in a CUDA graph (median of 5 replays). ``--replace
NAME=OLD=>NEW[@@OLD=>NEW]`` replaces text in whichever sources and headers
hold it; ``--trace`` adds a variant that stamps clock64 at the phases of
block 0 (``TRACE``) and prints its timelines for the u8 encoder and two T3
calls. Needs a CUDA device; prints the sums a frame and a step for each
source as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

FILES = {"thin": "conv_thin.cu", "t3": "conv_tc.cu"}
# (label, per frame, per step, kind, shape): thin calls (B, cin, H, W, u8);
# T3 calls (cout, h, w) of the cotangent
CALLS = [
    ("u8 3->32 352x1216", 1, 0, "thin", (2, 3, 352, 1216, True)),
    ("head 64 44x152 B2", 1, 0, "thin", (2, 64, 44, 152, False)),
    ("head 64 88x304 B2", 1, 0, "thin", (2, 64, 88, 304, False)),
    ("head 32 176x608 B2", 1, 0, "thin", (2, 32, 176, 608, False)),
    ("head 32 352x1216 B2", 1, 0, "thin", (2, 32, 352, 1216, False)),
    ("head 64 44x152 B1", 0, 1, "thin", (1, 64, 44, 152, False)),
    ("head 64 88x304 B1", 0, 1, "thin", (1, 64, 88, 304, False)),
    ("head 32 176x608 B1", 0, 1, "thin", (1, 32, 176, 608, False)),
    ("head 32 352x1216 B1", 0, 1, "thin", (1, 32, 352, 1216, False)),
    ("T3 128->32 176x608", 0, 1, "t3", (32, 176, 608)),
    ("T3 128->64 88x304", 0, 1, "t3", (64, 88, 304)),
    ("T3 128->64 44x152", 0, 1, "t3", (64, 44, 152)),
]
CENTRE = 64

# --trace: a variant of this tree's sources that stamps clock64 into a
# device buffer in block 0 (the u8 encoder's thread 0 at each tile's phases:
# 0 top, 1 window staged, 2-5 row r's wgmmas done, 6 rows staged, 7 tensor
# stores issued; T3's first consumer thread: 0 take, 1 / 3 parity
# row py computed, 2 / 4 stored; its producer warpgroups' first threads: 8 /
# 9 acquired (with tensor copies: the box landed), 10 / 11 published), read
# back through an added entry
_STAMP = ("#include \"hopper.cuh\"\n__device__ unsigned long long nct_trace_buf[512];\n"
          "#define NCT_STAMP(i, k) do { if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0 && "
          "(i) < 32) nct_trace_buf[(i) * 16 + (k)] = clock64(); } while (0)\n"
          "extern \"C\" int nct_trace_read(void* d) { return (int)cudaMemcpyFromSymbol(d, nct_trace_buf, "
          "sizeof(nct_trace_buf)); }\n")
TRACE = [
    ("#include \"hopper.cuh\"", _STAMP),
    ("  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n",
     "  int it_ = -1;\n  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n    ++it_; NCT_STAMP(it_, 0);\n"),
    ("    fetch(t + gridDim.x);  // the next", "    NCT_STAMP(it_, 1); fetch(t + gridDim.x);  // the next"),
    ("      hop::wgmma_wait<0>();\n      hop::fence_regs(acc);",
     "      hop::wgmma_wait<0>(); NCT_STAMP(it_, 2 + r);\n      hop::fence_regs(acc);"),
    ("    if (a.out_tma) {\n      hop::fence_async_shared();", "    NCT_STAMP(it_, 6);\n    if (a.out_tma) {\n"
     "      hop::fence_async_shared();"),
    ("        hop::bulk_commit();\n      }\n      continue;", "        hop::bulk_commit();\n      }\n"
     "      NCT_STAMP(it_, 7);\n      continue;"),
    ("      ring.acquire(i);\n      stage_tile<",
     "      ring.acquire(i); NCT_STAMP(i, 8 + (tid >> 7));\n      stage_tile<"),
    ("      ring.publish(i);\n    }\n    return;",
     "      NCT_STAMP(i, 10 + (tid >> 7)); ring.publish(i);\n    }\n    return;"),
    ("          hop::mbar_wait(landed, i & 1);",
     "          hop::mbar_wait(landed, i & 1); NCT_STAMP(i, 8 + (tid >> 7));"),
    ("          ring.publish(i);\n        }\n        return;",
     "          NCT_STAMP(i, 10 + (tid >> 7)); ring.publish(i);\n        }\n        return;"),
    ("    ring.take(i);\n    const uint32_t ab", "    ring.take(i); NCT_STAMP(i, 0);\n    const uint32_t ab"),
    ("        hop::named_sync(1 + c, 128);\n        store_rows<4, OW>(a, st, OS, a.cout, b, 0, 2 * (oy0 + 4 * c) + py, 2, "
     "2 * ox0, ctid, 128);",
     "        NCT_STAMP(i, 1 + 2 * py); hop::named_sync(1 + c, 128);\n        store_rows<4, OW>(a, st, OS, a.cout, b, 0, "
     "2 * (oy0 + 4 * c) + py, 2, 2 * ox0, ctid, 128); NCT_STAMP(i, 2 + 2 * py);"),
]
TRACE_CALLS = {0: "u8", 9: "t3", 10: "t3"}


def build(sources, kinds):
    """{name: (csrc dir, replacements)} -> {name: {kind: (library, takes a centre count)}}"""
    from nconv_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    procs = {}
    for name, (src_dir, reps) in sources.items():
        d = HERE / "build" / "thin_probe" / name
        d.mkdir(parents=True, exist_ok=True)
        texts = {h.name: h.read_text() for h in src_dir.glob("*.cuh")}
        texts.update({FILES[k]: (src_dir / FILES[k]).read_text() for k in kinds})
        for old, new in reps:
            hits = [f for f in texts if old in texts[f]]
            if not hits and name != "trace":  # the trace stamps what the built sources hold
                for _, p in procs.values():
                    p.kill()
                raise SystemExit(f"thin_probe: variant {name}: text not found: {old!r}")
            for f in hits:
                texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (d / f).write_text(text)
        for k in kinds:
            centre = "int relu, int centre, void* stream" in texts[FILES[k]]
            procs[(name, k)] = (centre, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-shared", str(d / FILES[k]), "-o", str(d / f"{k}.so")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    P, I = ctypes.c_void_p, ctypes.c_int
    out = {}
    for (name, k), (centre, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            for _, p in procs.values():
                p.kill()
            raise SystemExit(f"thin_probe: {name} {FILES[k]} did not build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(HERE / "build" / "thin_probe" / name / f"{k}.so"))
        if k == "thin":
            lib.nct_conv_thin.argtypes = [P, P, I, I, I, I, I, I, I, P, P, P, I, P, I, P]
        else:
            lib.nct_conv_tc.argtypes = ([P, P, I, I, I, I, I, I, I, P, I, I, P, P, I, P, I] + ([I] if centre else [])
                                        + [P])
        out.setdefault(name, {})[k] = (lib, centre)
    return out


def sass_counts(libs, kinds, pattern):
    """Per source, for each kernel whose mangled name matches pattern: its
    HGMMA (warpgroup MMA) and WARPGROUP.ARRIVE (register fence) counts in
    the compiled SASS (cuobjdump), beside its registers."""
    import re

    from nconv_tpu_torch.kernels import _nvcc

    dump = str(Path(_nvcc()).parent / "cuobjdump")
    for name in libs:
        for k in kinds:
            out = subprocess.run([dump, "-sass", str(HERE / "build" / "thin_probe" / name / f"{k}.so")],
                                 capture_output=True, text=True).stdout
            fn, counts = None, {}
            for line in out.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    fn = m.group(1) if re.search(pattern, m.group(1)) else None
                    if fn:
                        counts[fn] = {"HGMMA": 0, "WARPGROUP.ARRIVE": 0, "WARPGROUP.DEPBAR": 0}
                elif fn:
                    for op in counts[fn]:
                        counts[fn][op] += bool(re.search(r"\b" + re.escape(op) + r"\b", line))
            for f, c in counts.items():
                print(f"sass {name} {f}: {c}", flush=True)


def operands(kind, shape, g):
    """(launch args but the stream, output) of one call on random operands"""
    import torch

    from nconv_tpu_torch.kernels import part_args

    if kind == "thin":
        b, cin, h, w, u8 = shape
        if u8:
            x = torch.randint(0, 256, (b, h, w, cin), generator=g, device="cuda", dtype=torch.uint8).permute(0, 3, 1, 2)
            cout, wt = 32, torch.randn(32, cin, 3, 3, generator=g, device="cuda") * (9 * cin) ** -0.5 / 255
            sc = torch.randn(32, cin, 1, 1, generator=g, device="cuda") * cin ** -0.5 / 255
        else:
            x = torch.randn(b, cin, h, w, generator=g, device="cuda").to(torch.bfloat16)
            cout, wt, sc = 1, torch.randn(1, cin, 3, 3, generator=g, device="cuda") * (9 * cin) ** -0.5, None
        bias = torch.randn(cout, generator=g, device="cuda")
        out = torch.empty((b, cout, h, w), device="cuda", dtype=torch.bfloat16)
        ptrs, meta = part_args([x], [False])
        keep = (x, wt, sc, bias)
        args = (ptrs, meta, 1, 2 if u8 else 1, b, h, w, cin, cout, wt.data_ptr(),
                None if sc is None else sc.data_ptr(), bias.data_ptr(), 0, out.data_ptr(), 1 if u8 else 0)
        return args, out, keep
    cout, h, w = shape
    x = torch.randn(1, 128, h, w, generator=g, device="cuda").to(torch.bfloat16)
    wt = (torch.randn(128, cout, 3, 3, generator=g, device="cuda") * (9 * 128) ** -0.5).to(torch.bfloat16)
    wt[128 - CENTRE:] *= torch.nn.functional.pad(torch.ones(1, 1, 1, 1, device="cuda"), (1, 1, 1, 1)).to(wt.dtype)
    out = torch.empty((1, cout, 2 * h, 2 * w), device="cuda", dtype=torch.bfloat16)
    ptrs, meta = part_args([x], [False])
    args = (ptrs, meta, 1, 1, h, w, 128, cout, 3, wt.data_ptr(), 1, 0, None, None, 0, out.data_ptr(), 0)
    return args, out, (x, wt)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another tree whose sources are timed first")
    ap.add_argument("--kernel", choices=("thin", "t3", "both"), default="both")
    ap.add_argument("--replace", action="append", default=[], help="NAME=OLD=>NEW[@@OLD=>NEW], a variant")
    ap.add_argument("--trace", action="store_true", help="also a traced variant and block 0's timelines")
    ap.add_argument("--sass", default="", help="regex of kernel names whose HGMMA / WARPGROUP.ARRIVE counts to print")
    args = ap.parse_args()
    import torch

    from nconv_tpu_torch.kernels import CSRC

    if not torch.cuda.is_available():
        raise SystemExit("thin_probe: needs a CUDA device")
    kinds = ("thin", "t3") if args.kernel == "both" else (args.kernel,)
    sources = {}
    if args.parent:
        sources["parent"] = (Path(args.parent).resolve() / "nconv_tpu_torch" / "csrc", [])
    sources["tree"] = (CSRC, [])
    for r in args.replace:
        name, rest = r.split("=", 1)
        sources[name] = (CSRC, [tuple(x.split("=>")) for x in rest.split("@@")])
    if args.trace:
        sources["trace"] = (CSRC, TRACE)
    libs = build(sources, kinds)
    if args.sass:
        sass_counts(libs, kinds, args.sass)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for ci, (label, _, _, kind, shape) in enumerate(CALLS):
        if kind not in kinds:
            continue
        call, out, keep = operands(kind, shape, g)
        ref = None
        for name, by_kind in libs.items():
            lib, centre = by_kind[kind]
            entry = lib.nct_conv_thin if kind == "thin" else lib.nct_conv_tc
            full = call + ((CENTRE,) if kind == "t3" and centre else ())

            def run():
                e = entry(*full, torch.cuda.current_stream().cuda_stream)
                if e:
                    raise SystemExit(f"thin_probe: {name} returned {e} on {label}")

            run()
            torch.cuda.synchronize()
            if name == "trace" and ci in TRACE_CALLS:
                buf = (ctypes.c_ulonglong * 512)()
                lib.nct_trace_read.argtypes = [ctypes.c_void_p]
                lib.nct_trace_read(ctypes.addressof(buf))
                stamps = [list(buf[16 * i:16 * i + 16]) for i in range(32)]
                t0 = min(v for v in stamps[0] if v)
                print(f"trace, {label}: block 0, clock64 ticks / 1000 from its first stamp (0: none)")
                for i in range(12):
                    if any(stamps[i]):
                        print(f"  tile {i:2d} " + " ".join(f"{(v - t0) / 1000:7.2f}" if v else "      -"
                                                         for v in stamps[i][:12]))
            if ref is None:
                ref = out.clone()
            else:
                err = float((out.double() - ref.double()).norm() / ref.double().norm())
                if err > 5e-3:  # a diagnostic variant may cut work out; its time still prints
                    print(f"thin_probe: {name} disagrees on {label}: rel {err:.2e}", flush=True)
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
        del keep
        print(f"{label:<22} (us): " + " ".join(f"{n} {res[(ci, n)] * 1e3:.1f}" for n in libs), flush=True)
    sums = {n: {per: sum(res[(i, n)] * c[1 if per == "frame" else 2] for i, c in enumerate(CALLS) if (i, n) in res
                         and c[3] == k) for per, k in (("frame", "thin"), ("step", "thin"), ("t3 step", "t3"))}
            for n in libs}
    print(card)
    print(json.dumps({"ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
