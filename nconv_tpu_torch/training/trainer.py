"""Training harness of the port: the step-1 and step-2 tasks, the train
and eval steps, and the host-side loop (the JAX package's
``training/trainer.py``), on one device or data-parallel over a
:class:`~nconv_tpu_torch.parallel.Mesh` of ranks.

One train step is ``model.train()``, forward, ``loss.backward()`` and the
optimizer's step on the parameters that require grad, in place; evaluation
is ``model.eval()`` under ``torch.no_grad()``, which takes the fused serving
forward. On the card, step 1's forward runs K1 and its backward K2's K x K
form and K5 (``ops/nconv.py``); step 2's forward runs K1 (frozen step 1),
K2 and K3, and its backward K2's K x K forms, K3's 3x3/s2 form and K6
(``ops/conv_autograd.py``). :func:`grid_search` sweeps the learning rate
and weight decay one cell after another.

With a mesh of world size > 1 (``torchrun``, one process per GPU,
``make_mesh()``), every rank reads the same global batch from its loader
and keeps its shard; the loss and train-mode BatchNorm sum over the ranks
(``parallel/mesh.py``), the gradients are averaged over them, so a step is
the single-process step on the whole batch, and the losses reported are
the global ones. Rank 0 alone writes checkpoints, images and logs.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from ..data.pipeline import prefetch_to_device
from ..losses import depth_loss, multi_resolution_loss
from ..models import GuidedDepthNet, NConvUNet
from ..models.backend import resolve_device
from ..parallel.mesh import average_gradients, data_parallel, replicate, shard_batch
from ..utils.colormap import save_depth
from .checkpoint import CheckpointManager
from .config import GridSearchConfig, OptimizerConfig, TrainConfig
from .optim import build_optimizer, build_scheduler, set_learning_rate


class UnguidedTask:
    """Step-1 training: sparse depth -> dense depth, masked loss against GT.

    ``two_stream=True`` is the VOID harness's form, which duplicates the
    batch through the shared network and reads stream 0. Both streams carry
    the same tensor and the network couples no batch rows, so stream 0
    equals the single-stream forward: as in the JAX package, the duplicate
    is never computed, and both forms give the same loss and gradients.
    """

    name = "unguided"

    def __init__(self, model: NConvUNet | None = None, two_stream: bool = False):
        self.model = model if model is not None else NConvUNet()
        self.two_stream = two_stream

    def loss(self, batch: dict, *, cfg: TrainConfig) -> torch.Tensor:
        pred, _ = self.model(batch["depth"])
        return depth_loss(pred, batch["gt"], use_gradient_loss=cfg.use_gradient_loss)

    @torch.no_grad()
    def predict(self, batch: dict) -> torch.Tensor:
        return self.model(batch["depth"])[0]


class GuidedTask:
    """Step-2 training: RGB + sparse depth -> multi-scale refined depth,
    step 1 frozen, multi-resolution loss.

    The reference feeds the same (rgb, depth) to both streams and its loss
    reads stream 0. BN's batch mean and biased variance over [x; x] equal
    those over x, so stream 0 of the two-stream forward is the single-stream
    forward: as in the JAX package, only the single stream is computed.
    ``step1_state`` (an ``NConvUNet`` state dict) is loaded into the frozen
    step 1, whose parameters stop requiring grad, so the optimizer never
    sees them.
    """

    name = "guided"

    def __init__(self, model: GuidedDepthNet | None = None, step1_state: dict | None = None):
        self.model = model if model is not None else GuidedDepthNet()
        if step1_state is not None:
            self.model.step1.load_state_dict(step1_state)
        self.model.step1.requires_grad_(False)

    def loss(self, batch: dict, *, cfg: TrainConfig) -> torch.Tensor:
        scales, _ = self.model(batch["rgb"], batch["depth"])
        return multi_resolution_loss(scales, batch["gt"], use_gradient_loss=cfg.use_gradient_loss,
                                     batch_reduce=cfg.batch_reduce)

    @torch.no_grad()
    def predict(self, batch: dict) -> torch.Tensor:
        """The finest scale, (B, H, W, 1)."""
        return self.model(batch["rgb"], batch["depth"])[0][-1]


@dataclass
class FitResult:
    best_variables: dict
    best_val_loss: float
    history: dict = field(default_factory=dict)


def _host_copy(model: torch.nn.Module) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


class Trainer:
    """``Trainer(task, cfg).fit(train_loader, val_loader)``; the loaders are
    callables that return an iterable of numpy batch dicts. Runs on
    ``device`` (default ``cuda``; raises without a GPU). The optimizer takes
    the parameters that require grad, so a frozen step 1 keeps its values
    bit for bit; checkpoints hold the model's whole state dict, BN running
    statistics included.

    ``mesh`` (``parallel.make_mesh()``) trains data-parallel on the mesh's
    device, which takes the place of ``device``; the model's parameters and
    buffers start as rank 0's. Without a mesh, or at world size 1, this is
    the single-device trainer, bit for bit."""

    def __init__(
        self,
        task,
        cfg: TrainConfig,
        checkpoints: CheckpointManager | None = None,
        log_fn: Callable[[str], None] = print,
        device: str | torch.device | None = "cuda",
        mesh=None,
    ):
        self.task = task
        self.cfg = cfg
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0
        self.checkpoints = checkpoints
        self.log = log_fn if self.lead else (lambda msg: None)
        if mesh is not None and len(mesh.devices) != 1:
            raise ValueError(f"a training mesh holds one device a rank, not {len(mesh.devices)}")
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.model = task.model.to(self.device)
        if mesh is not None:
            replicate(self.model, mesh)
        self.optimizer = build_optimizer(cfg.optimizer, self.model.parameters())

    def _shards(self, loader: Callable[[], Iterable[dict]]):
        """The loader's batches as this rank's shards on the device."""
        batches = loader() if self.mesh is None else (shard_batch(b, self.mesh) for b in loader())
        return prefetch_to_device(batches, self.device)

    # -- steps -------------------------------------------------------------

    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a batch of device tensors; returns the
        loss before the step (a 0-d tensor, not synchronised)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with data_parallel(self.mesh):
            loss = self.task.loss(batch, cfg=self.cfg)
            loss.backward()
        if self.mesh is not None:
            average_gradients(self.model.parameters(), self.mesh)
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch: dict) -> torch.Tensor:
        self.model.eval()
        with data_parallel(self.mesh):
            return self.task.loss(batch, cfg=self.cfg)

    # -- the loop ----------------------------------------------------------

    def fit(
        self,
        train_loader: Callable[[], Iterable[dict]],
        val_loader: Callable[[], Iterable[dict]],
        *,
        resume: bool = True,
    ) -> FitResult:
        cfg = self.cfg
        self.optimizer = build_optimizer(cfg.optimizer, self.model.parameters())
        sched = build_scheduler(cfg.scheduler, cfg.optimizer.learning_rate, cfg.epochs)
        history: dict[str, list] = {"train_loss": [], "val_loss": [], "lr": []}
        start_epoch = 0
        best_val = float("inf")
        best_vars = None
        num_bad = 0

        if resume and self.checkpoints is not None:
            latest = self.checkpoints.latest_epoch()
            if latest is not None:
                state, meta = self.checkpoints.restore(latest)
                self.model.load_state_dict(state["model"])  # every rank reads rank 0's files
                self.optimizer.load_state_dict(state["optimizer"])
                history = meta["history"]
                best_val = float(meta["best_val"])
                start_epoch = latest + 1
                # the scheduler and early stop continue where they left off
                sched.load_state_dict(meta["sched"])
                num_bad = int(meta["num_bad"])
                best_vars = self.checkpoints.load_best_variables()
                self.log(f"[resume] continuing from epoch {start_epoch}")

        t_start = time.time()
        for epoch in range(start_epoch, cfg.epochs):
            losses = []
            t_step = time.time()
            for i, batch in enumerate(self._shards(train_loader)):
                loss = self.train_step(batch)
                losses.append(loss)
                if cfg.log_every and i % cfg.log_every == 0 and i > 0:
                    self.log(f"[epoch {epoch}] batch {i} loss {float(loss):.4f} "
                             f"({time.time() - t_step:.2f}s)")
                    t_step = time.time()
                if cfg.dump_images_every and i % cfg.dump_images_every == 0 and self.lead:
                    self._dump_images(batch, epoch, i)
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")

            val_losses = [float(self.eval_step(b)) for b in self._shards(val_loader)]
            val_loss = float(np.mean(val_losses)) if val_losses else float("nan")

            if cfg.nan_policy == "raise" and not (np.isfinite(train_loss) and np.isfinite(val_loss)):
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch}: train={train_loss} val={val_loss}; "
                    f"last good checkpoint is epoch {epoch - 1 if epoch else 'none'}"
                )

            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)

            if val_loss < best_val:
                best_val = val_loss
                best_vars = _host_copy(self.model)
                if self.checkpoints is not None and self.lead:
                    self.checkpoints.save_best_variables(best_vars)
                num_bad = 0
            else:
                num_bad += 1

            lr = sched.step(val_loss)
            set_learning_rate(self.optimizer, lr)
            history["lr"].append(lr)
            self.log(f"[epoch {epoch}] train {train_loss:.4f} val {val_loss:.4f} lr {lr:.2e}")

            if self.checkpoints is not None and (
                (epoch + 1) % cfg.checkpoint_every == 0 or epoch == cfg.epochs - 1
            ):
                if self.lead:
                    self.checkpoints.save(
                        epoch,
                        {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()},
                        meta={"history": history, "best_val": best_val,
                              "sched": sched.state_dict(), "num_bad": num_bad},
                    )
                if self.mesh is not None:
                    self.mesh.barrier()  # the files exist before any rank may resume from them

            if cfg.early_stopping and num_bad >= cfg.scheduler.patience + cfg.early_stop_extra:
                self.log(f"[early stop] epoch {epoch}")
                break

        self.log(f"training took {(time.time() - t_start) / 60:.2f} min; best val {best_val:.4f}")
        if best_vars is None:
            best_vars = _host_copy(self.model)
        return FitResult(best_vars, best_val, history)

    def _dump_images(self, batch: dict, epoch: int, batch_idx: int) -> None:
        """Debug dumps of batch element 0: prediction, sparse input and GT,
        each an inferno-coloured PNG (``utils.colormap.save_depth``)."""
        os.makedirs(self.cfg.image_dir, exist_ok=True)
        self.model.eval()
        pred = self.task.predict(batch)
        stem = os.path.join(self.cfg.image_dir, f"{self.cfg.run_name}_e{epoch}_b{batch_idx}")
        for suffix, t in (("_out", pred), ("_sparse", batch["depth"]), ("_gt", batch["gt"])):
            save_depth(t[0].float().cpu().numpy(), stem + suffix + ".png")


def cell_config(cfg: TrainConfig, lr: float, wd: float) -> TrainConfig:
    """``cfg`` with the optimizer's learning rate and weight decay of one
    grid cell."""
    o = cfg.optimizer
    return cfg.replace(optimizer=OptimizerConfig(o.name, lr, wd, o.momentum))


def cell_name(lr: float, wd: float) -> str:
    return f"lr{lr:g}_wd{wd:g}"


def grid_search(
    task_factory: Callable[[], object],
    cfg: TrainConfig,
    grid: GridSearchConfig,
    train_loader,
    val_loader,
    log_fn: Callable[[str], None] = print,
    checkpoint_dir: str | None = None,
    device: str | torch.device | None = "cuda",
    mesh=None,
):
    """Learning-rate x weight-decay sweep, one cell after another; returns
    ``(best FitResult, best lr, best wd)``. ``task_factory()`` gives each
    cell its task, model freshly initialised. ``mesh`` trains every cell
    data-parallel (:class:`Trainer`); rank 0 alone writes the results file.

    With ``checkpoint_dir`` the sweep resumes: each cell trains under its
    own per-epoch :class:`CheckpointManager` (``<dir>/<cell>``), finished
    cells are recorded in ``grid_results.json`` and skipped on a rerun, a
    cell cut mid-training resumes from its latest epoch, and a winner from
    an earlier run is reloaded from its cell's ``best_variables.pt``.

    Each cell reads the loaders' next epochs, so with loaders that shuffle
    or draw per pass (the datasets' sparsification) a later cell sees other
    batches than the first, as in the JAX package; the lockstep
    ``parallel_grid_search`` gives every cell the same batches.
    """
    if mesh is not None and mesh.rank != 0:
        log_fn = lambda msg: None  # noqa: E731
    results_path = os.path.join(checkpoint_dir, "grid_results.json") if checkpoint_dir else None
    done: dict[str, dict] = {}
    if results_path and os.path.isfile(results_path):
        with open(results_path) as f:
            done = json.load(f)

    best: FitResult | None = None
    best_lr = best_wd = best_cell = None
    for lr in grid.learning_rates:
        for wd in grid.weight_decays:
            cell = cell_name(lr, wd)
            if cell in done:
                log_fn(f"[grid] {cell}: already complete (val "
                       f"{done[cell]['best_val_loss']:.4f}), skipping")
                result = FitResult(None, float(done[cell]["best_val_loss"]),
                                   done[cell].get("history", {}))
            else:
                log_fn(f"[grid] lr={lr} wd={wd}")
                ckpts = (CheckpointManager(os.path.join(checkpoint_dir, cell), keep=cfg.keep_checkpoints)
                         if checkpoint_dir else None)
                trainer = Trainer(task_factory(), cell_config(cfg, lr, wd), checkpoints=ckpts,
                                  log_fn=log_fn, device=device, mesh=mesh)
                result = trainer.fit(train_loader, val_loader, resume=checkpoint_dir is not None)
                if results_path and trainer.lead:
                    done[cell] = {"lr": lr, "wd": wd, "best_val_loss": result.best_val_loss,
                                  "history": result.history}
                    with open(results_path, "w") as f:
                        json.dump(done, f)
            if best is None or result.best_val_loss < best.best_val_loss:
                best, best_lr, best_wd, best_cell = result, lr, wd, cell
    if best is not None and best.best_variables is None and checkpoint_dir:
        # the winner finished in an earlier run: its best model is on disk
        best.best_variables = CheckpointManager(
            os.path.join(checkpoint_dir, best_cell)).load_best_variables()
        if best.best_variables is None:
            raise FileNotFoundError(
                f"grid cell '{best_cell}' is marked complete in {results_path} but "
                f"{checkpoint_dir}/{best_cell}/best_variables.pt is missing; delete the "
                "cell's entry from grid_results.json to re-train it"
            )
    return best, best_lr, best_wd
