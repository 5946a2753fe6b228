"""Per-call times of the mixed frame's tensor-core and thin kernels
(``conv_tc``, ``conv_transpose_tc``, ``conv_chain_tc``, ``conv_thin``) and
the frame's three clocks, for the port found under ``--root`` (a checkout
or a ``git archive`` of any tree), so that two trees can be compared in
turns on one card:

    python3 scripts/tc_compare.py --root compare/parent --out build/tc_compare/parent_1.json
    python3 scripts/tc_compare.py --root . --out build/tc_compare/change_1.json

It records one two-stream 352x1216 request of the mixed ``StreamingEngine``
(random weights from a seed, as ``chip_smoke.py`` builds them), replays each
such call on random inputs of its shapes through ``chip_smoke.py``'s
``check_call`` (kernel vs plain version, single-launch ms, library ms,
bound), its device time and its library call's from CUDA graphs
(``graph_ms``), then takes ``runtime.benchmark``'s ``device`` / ``synced``
/ ``e2e`` p50 and a
``runtime.profile.trace`` of graphed requests (device ms a request by
kernel). Needs a CUDA device; prints one JSON object as its last line.

With ``--train`` it records one bf16 guided train step instead (batch 1,
352x1216, adamw, step 1 frozen, as ``chip_smoke.py`` phase 6) and times
each call of the backward's tensor-core forms (``wgrad_tc``,
``conv4x4s2_tc``, ``conv_transpose3x3s2_tc``, ``conv_input_grad_tc``) and
of the forward's four heads (``conv_thin``) the same way: kernel vs plain,
single-launch ms, device ms, its library call's device ms (both replayed
from a CUDA graph), bound; per-kernel sums a step;
and a ``runtime.profile.trace`` of train steps (busy ms a step, device ms a
step by kernel):

    python3 scripts/tc_compare.py --train --root compare/parent --out build/tc_compare/train_parent_1.json
"""
from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="tree whose nconv_tpu_torch is timed")
    ap.add_argument("--out", help="also write the JSON here")
    ap.add_argument("--train", action="store_true", help="the bf16 guided step's backward forms instead")
    ap.add_argument("--steps", type=int, default=10, help="train steps the profile traces (--train)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tc_compare: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    from nconv_tpu_torch import kernels
    from nconv_tpu_torch.runtime import StreamingEngine, benchmark
    from nconv_tpu_torch.runtime.profile import trace

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    kernels.lib()
    if args.train:
        out = train(cs, args.steps)
        out.update(root=str(Path(args.root).resolve()), card=card, torch=torch.__version__)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
        print(card)
        print(json.dumps({"sums": out["sums"], "busy_ms": out["device_busy_ms"], "by_kernel": out["device_ms_by_kernel"],
                          "disagree": out["disagree"]}))
        return 1 if out["disagree"] else 0
    state, frames = cs.random_state(), cs.synthetic_frames(cs.N_REQUESTS)
    eng = StreamingEngine(state, height=cs.H, width=cs.W, compute_dtype=torch.bfloat16)
    rec = cs.Recorder()
    with torch.no_grad(), rec.recording():
        eng.forward_staged(eng.stage(*frames[0]))
    torch.cuda.synchronize()
    g = torch.Generator(device="cuda").manual_seed(1234)
    results = {k: cs.check_call(k, g) for k in rec.calls if k[0] in cs.TC_SERVING + ("conv_thin",)}
    bad = {repr(k): r["err"] for k, r in results.items() if r["err"] > r["bar"]}
    stats = {k: v.as_dict() for k, v in benchmark(
        eng, n_frames=cs.BENCH_FRAMES, warmup=10, frame_factory=lambda i: frames[i % len(frames)]).items()}
    sums = cs.tc_breakdown(results, rec.calls, stats)
    sums["conv_thin"] = thin_breakdown(cs, results, rec.calls)
    cycle = itertools.cycle(frames)
    prof = trace(lambda: eng(*next(cycle)), cs.N_REQUESTS)
    by_kernel = {}
    for name, ms in prof["device_ms_per_request"].items():
        group = ("conv_chain_tc" if "chain_tc_kernel" in name else
                 "conv_thin" if "nct::thin::" in name else
                 "conv_tc (all modes)" if "conv_wg_kernel" in name or "conv_tc_kernel" in name else
                 "nconv" if "nconv" in name else "other")
        by_kernel[group] = by_kernel.get(group, 0.0) + ms
    out = dict(root=str(Path(args.root).resolve()), card=card, torch=torch.__version__, disagree=bad,
               calls=[{"key": repr(k), "count": rec.calls[k], **r} for k, r in results.items()],
               sums=sums, frame=stats, device_busy_ms=prof["device_busy_ms_per_request"],
               wall_ms=prof["wall_ms_per_request"], device_ms_by_kernel=by_kernel)
    print(f"device ms a graphed request by kernel: {by_kernel}; busy {prof['device_busy_ms_per_request']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(card)
    print(json.dumps({"sums": sums, "frame_p50": {k: v["p50_ms"] for k, v in stats.items()},
                      "by_kernel": by_kernel, "disagree": bad}))
    return 1 if bad else 0


def thin_breakdown(cs, results, calls):
    """Each ``conv_thin`` call of a mixed frame (the u8 encoder and the four
    heads): launches, single-launch ms, device ms, its library call's device
    ms, bound and share; returns their sums a frame."""
    mine = [(k, r) for k, r in results.items() if k[0] == "conv_thin" and k in calls]
    for key, r in mine:
        chans = "+".join(f"{sig[0][1]} {sig[1]}" for sig in key[1])
        cs.log(f"    conv_thin x{calls[key]} in {chans} out {r['shape'][0]}: ms {r['ms']:.4f} device "
               f"{r['device_ms']:.4f} lib device {r['library_device_ms']:.4f} bound {r['bound_ms']:.4f} "
               f"share {r['bound_ms'] / r['device_ms']:.1%} of device")
    sums = {f: sum(r[f] * calls[k] for k, r in mine) for f in ("ms", "device_ms", "library_device_ms", "bound_ms")}
    cs.log("per mixed frame: conv_thin " + ", ".join(f"{f} {v:.4f}" for f, v in sums.items()))
    return sums


# a kernel of the trace by its demangled name: nct::<namespace>::<kernel><MODE, ...
_TRAIN_GROUPS = (("wgrad_tc", r"nct::wtc::"), ("conv_thin", r"nct::thin::"),
                 ("conv4x4s2_tc", r"nct::tc::conv_\w+_kernel<4,"),
                 ("conv_transpose3x3s2_tc", r"nct::tc::conv_\w+_kernel<3,"),
                 ("conv_input_grad_tc", r"nct::tc::conv_wg_kernel<5,"), ("conv_tc (forward)", r"nct::tc::"),
                 ("other port kernels", r"nct::"))


def train(cs, steps):
    """One bf16 guided step's backward tensor-core calls and its heads, each
    timed and held to its plain version, their sums a step, and a profile
    of steps."""
    import torch

    from nconv_tpu_torch.data import bench_batch
    from nconv_tpu_torch.models import GuidedDepthNet, NConvUNet
    from nconv_tpu_torch.runtime.profile import _train_step, trace
    from nconv_tpu_torch.training import OptimizerConfig, TrainConfig

    batch = {k: torch.from_numpy(v).cuda() for k, v in bench_batch(cs.GUIDED_B, cs.H, cs.W).items()}
    cfg = TrainConfig(epochs=1, batch_size=cs.GUIDED_B, log_every=0, optimizer=OptimizerConfig("adamw", 1e-3, 1e-7))
    step1_state = NConvUNet(device="cuda", seed=0).state_dict()
    state = GuidedDepthNet(device="cuda", seed=0).state_dict()
    rec = cs.Recorder()
    with rec.recording():
        cs.guided_step(batch, torch.bfloat16, cfg, state, step1_state, plain=False)
    kinds = cs.BF16_STEP_KERNELS + ("conv_thin",)
    calls = {k: c for k, c in rec.calls.items() if k[0] in kinds}
    g = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for key in sorted(calls, key=repr):
        r = results[key] = cs.check_call(key, g)
        cs.log(f"    {key[0]:<22} x{calls[key]} out {r['shape'][0]} rel_rmse {r['err']:.2e} (bar {r['bar']:.0e}) "
               f"ms {r['ms']:.4f} device {r['device_ms']:.4f} lib {r['library_ms']} lib device "
               f"{r['library_device_ms']} bound {r['bound_ms']:.4f} ({r['bound_by']})"
               + (f" vs f64 {r['f64_err']:.3e} (plain {r['plain_f64_err']:.3e})" if "f64_err" in r else ""))
    bad = {repr(k): r["err"] for k, r in results.items() if r["err"] > r["bar"]}
    sums = cs.step_sums(calls, results, kinds)
    prof = trace(_train_step("guided", torch.bfloat16, cs.H, cs.W), steps)
    by_kernel = {}
    for name, ms in prof["device_ms_per_request"].items():
        group = next((g_ for g_, pat in _TRAIN_GROUPS if re.search(pat, name)), "plain ops and copies")
        by_kernel[group] = by_kernel.get(group, 0.0) + ms
    cs.log(f"device ms a bf16 guided step by kernel: {by_kernel}; busy {prof['device_busy_ms_per_request']} "
           f"of wall {prof['wall_ms_per_request']}")
    return dict(disagree=bad, calls=[{"key": repr(k), "count": calls[k], **r} for k, r in results.items()],
                sums=sums, device_busy_ms=prof["device_busy_ms_per_request"],
                wall_ms=prof["wall_ms_per_request"], device_ms_by_kernel=by_kernel)


if __name__ == "__main__":
    sys.exit(main())
