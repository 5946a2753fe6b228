"""Per-call times of the mixed frame's tensor-core kernels (``conv_tc``,
``conv_transpose_tc``, ``conv_chain_tc``) and the frame's three clocks, for
the port found under ``--root`` (a checkout or a ``git archive`` of any
tree), so that two trees can be compared in turns on one card:

    python3 scripts/tc_compare.py --root compare/parent --out build/tc_compare/parent_1.json
    python3 scripts/tc_compare.py --root . --out build/tc_compare/change_1.json

It records one two-stream 352x1216 request of the mixed ``StreamingEngine``
(random weights from a seed, as ``chip_smoke.py`` builds them), replays each
tensor-core call on random inputs of its shapes through ``chip_smoke.py``'s
``check_call`` (kernel vs plain version, single-launch ms, library ms,
bound) and its device time from a CUDA graph (``graph_ms``), then takes
``runtime.benchmark``'s ``device`` / ``synced`` / ``e2e`` p50 and a
``runtime.profile.trace`` of graphed requests (device ms a request by
kernel). Needs a CUDA device; prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="tree whose nconv_tpu_torch is timed")
    ap.add_argument("--out", help="also write the JSON here")
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
    state, frames = cs.random_state(), cs.synthetic_frames(cs.N_REQUESTS)
    eng = StreamingEngine(state, height=cs.H, width=cs.W, compute_dtype=torch.bfloat16)
    rec = cs.Recorder()
    with torch.no_grad(), rec.recording():
        eng.forward_staged(eng.stage(*frames[0]))
    torch.cuda.synchronize()
    g = torch.Generator(device="cuda").manual_seed(1234)
    results = {k: cs.check_call(k, g) for k in rec.calls if k[0] in cs.TC_SERVING}
    bad = {repr(k): r["err"] for k, r in results.items() if r["err"] > r["bar"]}
    stats = {k: v.as_dict() for k, v in benchmark(
        eng, n_frames=cs.BENCH_FRAMES, warmup=10, frame_factory=lambda i: frames[i % len(frames)]).items()}
    sums = cs.tc_breakdown(results, rec.calls, stats)
    cycle = itertools.cycle(frames)
    prof = trace(lambda: eng(*next(cycle)), cs.N_REQUESTS)
    by_kernel = {}
    for name, ms in prof["device_ms_per_request"].items():
        group = ("conv_chain_tc" if "chain_tc_kernel" in name else
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


if __name__ == "__main__":
    sys.exit(main())
