"""Command line of the port (the JAX package's ``cli.py``):

  python -m nconv_tpu_torch train-step1 --dataset nyu --root /data/nyu ...
  python -m nconv_tpu_torch train-step2 --step1-checkpoint checkpoints/run ...
  python -m nconv_tpu_torch eval --checkpoint checkpoints/run --model guided ...
  python -m nconv_tpu_torch infer --checkpoint ... --rgb-glob ... --depth-glob ...
  python -m nconv_tpu_torch bench [--throughput --batch 8 | --train]
  python -m nconv_tpu_torch profile [--mixed]
  python -m nconv_tpu_torch export --checkpoint checkpoints/g --out model.pt2 [--format onnx]
  python -m nconv_tpu_torch convert --pth ref.pth.tar --out checkpoints/converted [--reverse]

Every command runs on the card (``--device cuda``, the default: the
hand-written kernels) unless given ``--device cpu`` (their plain PyTorch
versions); without a GPU, ``cuda`` raises. The tensors' device is the only
thing that picks a path. Checkpoints are the port's ``torch.save`` files
(``training.save_best``).
"""
from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import sys
import time

import numpy as np
import torch

POS_FNS = ["softplus", "identity", "exp", "sigmoid", "softmax"]


def _add_device(p: argparse.ArgumentParser):
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="cuda runs the hand-written kernels, cpu their plain PyTorch versions",
    )


def _add_train_common(p: argparse.ArgumentParser):
    p.add_argument(
        "--dataset",
        choices=["nyu", "void", "kitti", "kitti_selval", "kitti_test", "synthetic"],
        default="synthetic",
    )
    p.add_argument("--root", default=None, help="dataset root directory")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--eval-batch-size", type=int, default=1)
    p.add_argument(
        "--dump-images-every", type=int, default=0,
        help="dump colour-mapped pred/sparse/gt PNGs every N train batches",
    )
    p.add_argument("--image-dir", default="tmp")
    p.add_argument("--lr", type=float, nargs="+", default=[1e-2])
    p.add_argument("--weight-decay", type=float, nargs="+", default=[1e-7])
    p.add_argument("--optimizer", choices=["adamw", "sgd", "rmsprop"], default="adamw")
    p.add_argument("--scheduler", choices=["plateau", "linear", "constant"], default="plateau")
    p.add_argument("--no-gradient-loss", action="store_true")
    p.add_argument("--apply-mask", action="store_true", default=True)
    p.add_argument("--no-apply-mask", dest="apply_mask", action="store_false")
    p.add_argument("--add-noise", action="store_true")
    p.add_argument("--early-stopping", action="store_true")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--name", default="run")
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--limit", type=int, default=None, help="cap dataset size (smoke runs)")
    p.add_argument("--seed", type=int, default=0)
    _add_device(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nconv-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("train-step1", help="train the unguided NConv densifier")
    _add_train_common(p1)
    p1.add_argument(
        "--two-stream", action="store_true",
        help="train through the two-stream form (the VOID harness's; the same loss)",
    )
    p1.add_argument(
        "--grid-parallel", action="store_true",
        help="train all lr x wd grid cells in lockstep: each batch staged once, "
             "every cell's step on it (default: one cell after another, resumable)",
    )

    p2 = sub.add_parser("train-step2", help="train the RGB-guided fusion net")
    _add_train_common(p2)
    p2.add_argument("--step1-checkpoint", default=None, help="step-1 best-model file")
    p2.add_argument("--batch-reduce", choices=["mean", "first"], default="mean")
    p2.add_argument(
        "--precision", choices=["f32", "bf16"], default="f32",
        help="bf16 runs the RGB/fusion feature convs in bf16 while the frozen "
             "step-1 densifier, every depth tensor, the loss and the master "
             "weights stay f32",
    )

    pb = sub.add_parser("bench", help="latency / throughput / train-step benchmark")
    pb.add_argument("--height", type=int, default=352)
    pb.add_argument("--width", type=int, default=1216)
    pb.add_argument("--frames", type=int, default=200)
    pb.add_argument("--checkpoint", default=None)
    pb.add_argument(
        "--pos-fn", choices=POS_FNS, default="softplus",
        help="step-1 kernel transform; 'identity' for converted reference weights",
    )
    pb.add_argument(
        "--throughput", action="store_true",
        help="batched two-stream bf16 throughput instead of latency",
    )
    pb.add_argument("--batch", type=int, default=8)
    pb.add_argument(
        "--train", action="store_true",
        help="train-step ms a batch (unguided b=4 + guided b=1) instead of inference latency",
    )
    pb.add_argument(
        "--precision", choices=["f32", "bf16"], default="f32",
        help="with --train: run the guided step in the mixed schedule",
    )
    _add_device(pb)

    pp = sub.add_parser("profile", help="per-kernel device time of a two-stream request")
    pp.add_argument("--height", type=int, default=352)
    pp.add_argument("--width", type=int, default=1216)
    pp.add_argument("--iters", type=int, default=3)
    pp.add_argument("--checkpoint", default=None)
    pp.add_argument("--pos-fn", choices=POS_FNS, default="softplus")
    pp.add_argument(
        "--mixed", action="store_true",
        help="profile the mixed schedule (bf16 features, f32 depth path), BN folded",
    )
    _add_device(pp)

    pe = sub.add_parser("export", help="export the guided net (a torch.export program or the deployment ONNX)")
    pe.add_argument("--checkpoint", required=True)
    pe.add_argument("--out", required=True)
    pe.add_argument("--height", type=int, default=480)
    pe.add_argument("--width", type=int, default=640)
    pe.add_argument(
        "--batch", type=int, default=None,
        help="fixed batch size; default exports a dynamic batch axis (the reference ONNX contract)",
    )
    pe.add_argument(
        "--format", choices=("pt2", "onnx"), default="pt2",
        help="pt2 = a torch.export program of the BN-folded net, run on --device (on the card its "
             "kernels are the hand-written ones); onnx = the reference's deployment artifact, traced "
             "from the plain path on the CPU, always dynamic-batch, --batch ignored",
    )
    pe.add_argument(
        "--kernel-mode", choices=("softplus", "raw"), default="softplus",
        help="step-1 kernels: 'softplus' for models trained here (pos_fn='softplus'), 'raw' for "
             "checkpoints converted with --kernel-mode raw (pos_fn='identity')",
    )
    pe.add_argument(
        "--selftest", action="store_true",
        help="validate the artifact: pt2 reloaded and run against the eager export (b = 1, 2); onnx "
             "checked for the contract and executed by the port's numpy executor "
             "against the plain path (<1e-4 rel RMSE)",
    )
    _add_device(pe)

    pc = sub.add_parser(
        "convert",
        help="convert a reference .pth.tar checkpoint (or, with --reverse, write one of ours in the "
             "reference format)",
    )
    pc.add_argument("--pth", required=True,
                    help="reference .pth.tar: the input, or with --reverse the output path")
    pc.add_argument("--out", help="destination checkpoint (forward mode)")
    pc.add_argument("--model", choices=["unguided", "guided"], default="guided")
    pc.add_argument(
        "--kernel-mode", choices=["raw", "softplus_inverse"], default="softplus_inverse",
        help="softplus_inverse (default) makes the converted checkpoint work with the default "
             "pos_fn='softplus' models; 'raw' keeps reference weights verbatim and needs --pos-fn "
             "identity (--kernel-mode raw for export). With --reverse the default writes the "
             "effective softplus'd kernels (what a reference checkpoint carries); 'raw' copies them",
    )
    pc.add_argument("--reverse", action="store_true",
                    help="write OUR checkpoint (--checkpoint) as a reference-format .pth.tar at --pth")
    pc.add_argument("--checkpoint", help="our checkpoint to write (reverse mode)")

    pv = sub.add_parser("eval", help="evaluate a checkpoint on a dataset")
    _add_train_common(pv)
    pv.add_argument("--checkpoint", required=True)
    pv.add_argument("--model", choices=["unguided", "guided"], default="guided")
    pv.add_argument("--split", default="val")
    pv.add_argument("--max-batches", type=int, default=None)
    pv.add_argument("--pos-fn", choices=POS_FNS, default="softplus")

    pi = sub.add_parser("infer", help="densify a directory of frames")
    pi.add_argument("--checkpoint", required=True)
    pi.add_argument("--rgb-glob", default=None)
    pi.add_argument("--depth-glob", default=None)
    pi.add_argument(
        "--dataset", choices=["kitti_test", "kitti_selval", "nyu", "void"], default=None,
        help="read frames from a dataset reader instead of file globs",
    )
    pi.add_argument("--root", default=None, help="dataset root for --dataset")
    pi.add_argument("--split", default="val", help="split for nyu/void --dataset")
    pi.add_argument("--limit", type=int, default=None)
    pi.add_argument("--out-dir", required=True)
    pi.add_argument("--height", type=int, default=480)
    pi.add_argument("--width", type=int, default=640)
    pi.add_argument("--pos-fn", choices=POS_FNS, default="softplus")
    pi.add_argument(
        "--mixed", action="store_true",
        help="bf16 feature convs, f32 depth path (the headline engine mode)",
    )
    _add_device(pi)
    return ap


# ---------------------------------------------------------------------------
# dataset / loader assembly
# ---------------------------------------------------------------------------

class _Limited:
    def __init__(self, ds, n):
        self.ds, self.n = ds, min(n, len(ds))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def make_dataset(args, mode: str):
    from .data import (
        KITTIDataset,
        KITTISelValDataset,
        KITTITestDataset,
        NYUDataset,
        SyntheticDataset,
        VOIDDataset,
    )

    if args.dataset == "synthetic":
        ds = SyntheticDataset(
            n=32 if mode == "train" else 8,
            height=args.height or 480,
            width=args.width or 640,
            seed=0 if mode == "train" else 1,
        )
    elif args.dataset == "nyu":
        ds = NYUDataset(
            args.root, mode, getattr(args, "apply_mask", True), getattr(args, "add_noise", False)
        )
    elif args.dataset == "void":
        ds = VOIDDataset(args.root, mode, use_mask=getattr(args, "apply_mask", True))
    elif args.dataset == "kitti_selval":
        ds = KITTISelValDataset(args.root)
    elif args.dataset == "kitti_test":
        ds = KITTITestDataset(args.root)
    else:
        ds = KITTIDataset(args.root, mode)
    if args.limit:
        ds = _Limited(ds, args.limit)
    return ds


def make_loaders(args):
    from .data import Loader

    if args.dataset in ("kitti_selval", "kitti_test"):
        raise SystemExit(
            f"--dataset {args.dataset} is evaluation-only (single split"
            + (", no ground truth" if args.dataset == "kitti_test" else "")
            + "); train on 'kitti' and evaluate with `nconv-tpu-torch eval`."
        )
    train = Loader(make_dataset(args, "train"), args.batch_size, shuffle=True,
                   num_workers=args.num_workers, seed=args.seed)
    val = Loader(make_dataset(args, "val"), getattr(args, "eval_batch_size", 1),
                 num_workers=args.num_workers)
    return (lambda: iter(train)), (lambda: iter(val))


def _train_cfg(args, batch_reduce="mean"):
    from .training import OptimizerConfig, SchedulerConfig, TrainConfig

    return TrainConfig(
        epochs=args.epochs,
        batch_size=args.batch_size,
        eval_batch_size=getattr(args, "eval_batch_size", 1),
        use_gradient_loss=not args.no_gradient_loss,
        batch_reduce=batch_reduce,
        optimizer=OptimizerConfig(args.optimizer, args.lr[0], args.weight_decay[0]),
        scheduler=SchedulerConfig(args.scheduler),
        early_stopping=args.early_stopping,
        checkpoint_dir=args.checkpoint_dir,
        run_name=args.name,
        seed=args.seed,
        dump_images_every=getattr(args, "dump_images_every", 0),
        image_dir=getattr(args, "image_dir", "tmp"),
    )


def _dtype(mixed: bool) -> torch.dtype:
    return torch.bfloat16 if mixed else torch.float32


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

def cmd_train_step1(args) -> int:
    from .models import NConvUNet, resolve_device
    from .training import (
        CheckpointManager,
        GridSearchConfig,
        Trainer,
        UnguidedTask,
        grid_search,
        parallel_grid_search,
        save_best,
    )

    dev = resolve_device(args.device)
    cfg = _train_cfg(args)
    train_loader, val_loader = make_loaders(args)
    grid = GridSearchConfig(args.lr, args.weight_decay)
    task_factory = lambda: UnguidedTask(NConvUNet(device=dev, seed=args.seed), two_stream=args.two_stream)
    if len(args.lr) * len(args.weight_decay) > 1:
        if args.grid_parallel:
            best, lr, wd = parallel_grid_search(task_factory, cfg, grid, train_loader, val_loader,
                                                device=dev)
        else:
            best, lr, wd = grid_search(task_factory, cfg, grid, train_loader, val_loader,
                                       checkpoint_dir=f"{args.checkpoint_dir}/{args.name}_grid",
                                       device=dev)
        print(f"grid best: lr={lr} wd={wd} val={best.best_val_loss:.4f}")
    else:
        ckpts = CheckpointManager(f"{args.checkpoint_dir}/{args.name}_epochs", keep=3)
        best = Trainer(task_factory(), cfg, checkpoints=ckpts, device=dev).fit(train_loader, val_loader)
    path = save_best(args.checkpoint_dir, args.name, best.best_variables)
    print(f"saved best model to {path} (val {best.best_val_loss:.4f})")
    return 0


def cmd_train_step2(args) -> int:
    from .models import GuidedDepthNet, resolve_device
    from .training import CheckpointManager, GuidedTask, Trainer, load_best, save_best

    dev = resolve_device(args.device)
    step1_state = load_best(args.step1_checkpoint) if args.step1_checkpoint else None
    cfg = _train_cfg(args, batch_reduce=args.batch_reduce)
    train_loader, val_loader = make_loaders(args)
    ckpts = CheckpointManager(f"{args.checkpoint_dir}/{args.name}_epochs", keep=3)
    # bf16: the feature convs in bf16, step 1, depth path and master weights f32
    model = GuidedDepthNet(dtype=_dtype(args.precision == "bf16"), device=dev, seed=args.seed)
    trainer = Trainer(GuidedTask(model, step1_state=step1_state), cfg, checkpoints=ckpts, device=dev)
    best = trainer.fit(train_loader, val_loader)
    path = save_best(args.checkpoint_dir, args.name, best.best_variables)
    print(f"saved best model to {path} (val {best.best_val_loss:.4f})")
    return 0


def cmd_eval(args) -> int:
    from .data import Loader
    from .models import GuidedDepthNet, NConvUNet, resolve_device
    from .training import evaluate, load_best, make_guided_predict, make_unguided_predict

    if args.dataset == "kitti_test":
        raise SystemExit(
            "kitti_test (test_depth_completion_anonymous) carries no ground "
            "truth, so there is nothing to score; produce dense maps with "
            "`nconv-tpu-torch infer` instead."
        )
    dev = resolve_device(args.device)
    state = load_best(args.checkpoint)
    if args.model == "guided":
        model = GuidedDepthNet(step1_pos_fn=args.pos_fn, device=dev)
        model.load_state_dict(state)
        predict = make_guided_predict(model)
    else:
        model = NConvUNet(pos_fn=args.pos_fn, device=dev)
        model.load_state_dict(state)
        predict = make_unguided_predict(model)
    loader = Loader(make_dataset(args, args.split), args.batch_size, num_workers=args.num_workers)
    result = evaluate(predict, loader, max_batches=args.max_batches)
    print(json.dumps({k: round(v, 6) for k, v in result.items()}))
    return 0


def cmd_infer(args) -> int:
    from .data import io as data_io
    from .models import GuidedDepthNet, resolve_device
    from .runtime import StreamingEngine
    from .training import load_best
    from .utils import save_depth

    dev = resolve_device(args.device)
    state = load_best(args.checkpoint)
    if args.dataset:
        if not args.root:
            raise SystemExit("--dataset requires --root")
        ds = make_dataset(args, args.split)
        n = len(ds)
        frames = ((ds[i]["rgb"], ds[i]["depth"][..., 0], f"{i:06d}") for i in range(n))
        h, w = ds[0]["rgb"].shape[:2]
    else:
        if not (args.rgb_glob and args.depth_glob):
            raise SystemExit("provide --rgb-glob/--depth-glob or --dataset/--root")
        rgbs = sorted(globlib.glob(args.rgb_glob))
        depths = sorted(globlib.glob(args.depth_glob))
        n = len(rgbs)

        def _load(rp, dp):
            d = data_io.load_depth_png16(dp) if dp.endswith(".png") else np.load(dp).astype(np.float32)
            return data_io.load_rgb(rp), d, os.path.splitext(os.path.basename(rp))[0]

        frames = (_load(rp, dp) for rp, dp in zip(rgbs, depths))
        h, w = args.height, args.width

    model = GuidedDepthNet(step1_pos_fn=args.pos_fn, dtype=_dtype(args.mixed), device=dev)
    engine = StreamingEngine(state, height=h, width=w, model=model, device=dev)
    engine.warmup()
    os.makedirs(args.out_dir, exist_ok=True)

    def _save(out, base):
        dense = out[0, :, :, 0].float().cpu().numpy()
        data_io.save_depth_png16(os.path.join(args.out_dir, base + "_depth.png"), dense)
        save_depth(dense, os.path.join(args.out_dir, base + "_vis.png"))

    # the deployed graph takes two camera streams a forward: frames go in
    # pairs, so N frames cost ceil(N / 2) requests; an odd last frame fills
    # both streams
    done = 0
    pending = None
    for frame in frames:
        if pending is None:
            pending = frame
            continue
        (r0, d0, b0), (r1, d1, b1) = pending, frame
        pending = None
        out0, out1 = engine(r0, d0, r1, d1)
        _save(out0, b0)
        _save(out1, b1)
        done += 2
        print(f"[{done}/{n}] {b0} {b1}")
    if pending is not None:
        rgb, d, base = pending
        out0, _ = engine(rgb, d, rgb, d)
        _save(out0, base)
        done += 1
        print(f"[{done}/{n}] {base}")
    return 0


def cmd_bench(args) -> int:
    from .models import GuidedDepthNet, resolve_device
    from .runtime import StreamingEngine, benchmark, benchmark_throughput
    from .training import load_best

    dev = resolve_device(args.device)
    if args.train:
        return _bench_train(args, dev)
    h, w = args.height, args.width
    if args.checkpoint:
        state = load_best(args.checkpoint)
    else:
        state = GuidedDepthNet(step1_pos_fn=args.pos_fn, device=dev).state_dict()
    if args.throughput:
        # batched two-stream throughput of the folded mixed-schedule model
        model = GuidedDepthNet(step1_pos_fn=args.pos_fn, dtype=torch.bfloat16, device=dev)
        fps = benchmark_throughput(state, height=h, width=w, batch=args.batch, model=model, device=dev)
        print(json.dumps({"throughput_fps": round(fps, 2), "batch": args.batch}))
        return 0
    model = GuidedDepthNet(step1_pos_fn=args.pos_fn, device=dev)
    engine = StreamingEngine(state, height=h, width=w, model=model, device=dev)
    engine.warmup()
    stats = benchmark(engine, n_frames=args.frames)
    # the JAX command's keys: each clock's stats without the clock's name
    print(json.dumps({k: {f: x for f, x in v.as_dict().items() if f != "clock"} for k, v in stats.items()}))
    return 0


def _bench_train(args, dev) -> int:
    """Train-step ms a batch at the requested size: step 1 at batch 4 and
    the guided net at batch 1, ten steps after one untimed step."""
    from .data import bench_batch
    from .models import GuidedDepthNet, NConvUNet
    from .training import GuidedTask, OptimizerConfig, TrainConfig, Trainer, UnguidedTask

    h, w = args.height, args.width
    precision = args.precision
    out = {"backend": dev.type, "height": h, "width": w, "precision": precision}
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for name, task, b in (
        ("unguided", lambda: UnguidedTask(NConvUNet(device=dev)), 4),
        ("guided", lambda: GuidedTask(GuidedDepthNet(dtype=_dtype(precision == "bf16"), device=dev)), 1),
    ):
        cfg = TrainConfig(epochs=1, batch_size=b, optimizer=OptimizerConfig("adamw", 1e-3, 1e-7),
                          log_every=0)
        trainer = Trainer(task(), cfg, log_fn=lambda m: None, device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in bench_batch(b, h, w).items()}
        trainer.train_step(batch)
        sync()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_step(batch)
        sync()
        out[f"{name}_train_ms_per_batch"] = round((time.perf_counter() - t0) / n * 1e3, 3)
        out[f"{name}_batch_size"] = b
    print(json.dumps(out))
    return 0


def cmd_profile(args) -> int:
    if args.device != "cuda":
        raise SystemExit("profile: device time needs --device cuda")
    from .models import resolve_device
    from .runtime import profile
    from .training import load_best

    resolve_device(args.device)
    state = load_best(args.checkpoint) if args.checkpoint else None
    run = profile.request(_dtype(args.mixed), args.height, args.width, state, args.pos_fn)
    out = {"card": profile.card(), "what": "request", "dtype": "bf16" if args.mixed else "f32",
           "hw": [args.height, args.width], **profile.trace(run, args.iters)}
    print(json.dumps(out))
    return 0


def cmd_export(args) -> int:
    from .training import load_best

    state = load_best(args.checkpoint)
    if args.format == "onnx":
        from .compat import export_guided_onnx, read_onnx_summary, selftest_guided_onnx

        path = export_guided_onnx(state, args.out, height=args.height, width=args.width,
                                  kernel_mode=args.kernel_mode)
        s = read_onnx_summary(path)
        print(f"exported deployment ONNX to {path} (opset {s['opset']}, inputs {s['inputs']}, "
              f"outputs {s['outputs']}, {s['total_weight_floats']} weight floats)")
        if args.selftest:
            s = selftest_guided_onnx(path, state, height=args.height, width=args.width,
                                     kernel_mode=args.kernel_mode)
            print("selftest: structure OK; executed by the numpy executor, rel RMSE vs the plain path "
                  f"{s['exec_rel_rmse']:.3g}")
        return 0
    from .compat.onnx_export import selftest_frames
    from .models import GuidedDepthNet, maybe_fold, resolve_device
    from .runtime import export_guided, load_exported, save_exported

    dev = resolve_device(args.device)
    pos_fn = "softplus" if args.kernel_mode == "softplus" else "identity"
    model, state = maybe_fold(GuidedDepthNet(step1_pos_fn=pos_fn, device=dev), state)
    model.load_state_dict({k: v.to(dev) for k, v in state.items()})
    path = save_exported(export_guided(model, height=args.height, width=args.width, batch=args.batch),
                         args.out)
    print(f"exported a torch.export program ({dev.type}) to {path}")
    if args.selftest:
        call, worst = load_exported(path), 0.0
        for b in ((1, 2) if args.batch is None else (args.batch,)):
            rgb, dep = (torch.from_numpy(a).permute(0, 2, 3, 1).to(dev) for a in
                        selftest_frames(args.height, args.width, b))
            got, want = call(rgb, dep, rgb, dep), model.export(rgb, dep, rgb, dep)
            worst = max([worst] + [float((g.double() - w.double()).norm() / w.double().norm().clamp_min(1e-30))
                                   for g, w in zip(got, want)])
        if worst >= 1e-4:
            raise SystemExit(f"selftest: the reloaded program is {worst:.3g} rel RMSE from the eager export")
        print(f"selftest: reloaded, rel RMSE vs the eager export {worst:.3g}")
    return 0


def cmd_convert(args) -> int:
    from .compat import (
        convert_guided_state_dict,
        convert_unguided_state_dict,
        load_pth_tar,
        save_pth_tar,
    )
    from .training import load_best, save_best

    if args.reverse:
        if not args.checkpoint:
            print("--reverse needs --checkpoint", file=sys.stderr)
            return 2
        # the reverse of the forward default: 'softplus_inverse' stores raw
        # parameters for pos_fn='softplus' models, so softplus them back
        mode = "softplus" if args.kernel_mode == "softplus_inverse" else "raw"
        save_pth_tar(args.pth, load_best(args.checkpoint), model=args.model, kernel_mode=mode)
        print(f"exported {args.checkpoint} -> {args.pth}")
        return 0
    if not args.out:
        print("forward conversion needs --out", file=sys.stderr)
        return 2
    convert = convert_guided_state_dict if args.model == "guided" else convert_unguided_state_dict
    state = convert(load_pth_tar(args.pth), kernel_mode=args.kernel_mode)
    directory, name = os.path.split(args.out)
    path = save_best(directory or ".", name, state)
    print(f"converted {args.pth} -> {path}")
    return 0


COMMANDS = {
    "train-step1": cmd_train_step1,
    "train-step2": cmd_train_step2,
    "bench": cmd_bench,
    "profile": cmd_profile,
    "eval": cmd_eval,
    "infer": cmd_infer,
    "export": cmd_export,
    "convert": cmd_convert,
}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
