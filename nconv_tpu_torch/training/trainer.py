"""Training harness of the port: the step-1 and step-2 tasks, the train
and eval steps, and the host-side loop (the JAX package's
``training/trainer.py``, single device).

One train step is ``model.train()``, forward, ``loss.backward()`` and the
optimizer's step on the parameters that require grad, in place; evaluation
is ``model.eval()`` under ``torch.no_grad()``, which takes the fused serving
forward. On the card, step 1's forward runs K1 and its backward K2's K x K
form and K5 (``ops/nconv.py``); step 2's forward runs K1 (frozen step 1),
K2 and K3, and its backward K2's K x K forms, K3's 3x3/s2 form and K6
(``ops/conv_autograd.py``).
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from ..data.pipeline import prefetch_to_device
from ..losses import depth_loss, multi_resolution_loss
from ..models import GuidedDepthNet, NConvUNet
from ..models.backend import resolve_device
from .checkpoint import CheckpointManager
from .config import TrainConfig
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
    statistics included."""

    def __init__(
        self,
        task,
        cfg: TrainConfig,
        checkpoints: CheckpointManager | None = None,
        log_fn: Callable[[str], None] = print,
        device: str | torch.device | None = "cuda",
    ):
        self.task = task
        self.cfg = cfg
        self.checkpoints = checkpoints
        self.log = log_fn
        self.device = resolve_device(device)
        self.model = task.model.to(self.device)
        self.optimizer = build_optimizer(cfg.optimizer, self.model.parameters())

    # -- steps -------------------------------------------------------------

    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a batch of device tensors; returns the
        loss before the step (a 0-d tensor, not synchronised)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.task.loss(batch, cfg=self.cfg)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch: dict) -> torch.Tensor:
        self.model.eval()
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
                self.model.load_state_dict(state["model"])
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
            for i, batch in enumerate(prefetch_to_device(train_loader(), self.device)):
                loss = self.train_step(batch)
                losses.append(loss)
                if cfg.log_every and i % cfg.log_every == 0 and i > 0:
                    self.log(f"[epoch {epoch}] batch {i} loss {float(loss):.4f} "
                             f"({time.time() - t_step:.2f}s)")
                    t_step = time.time()
                if cfg.dump_images_every and i % cfg.dump_images_every == 0:
                    self._dump_images(batch, epoch, i)
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")

            val_losses = [float(self.eval_step(b))
                          for b in prefetch_to_device(val_loader(), self.device)]
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
                if self.checkpoints is not None:
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
                self.checkpoints.save(
                    epoch,
                    {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()},
                    meta={"history": history, "best_val": best_val,
                          "sched": sched.state_dict(), "num_bad": num_bad},
                )

            if cfg.early_stopping and num_bad >= cfg.scheduler.patience + cfg.early_stop_extra:
                self.log(f"[early stop] epoch {epoch}")
                break

        self.log(f"training took {(time.time() - t_start) / 60:.2f} min; best val {best_val:.4f}")
        if best_vars is None:
            best_vars = _host_copy(self.model)
        return FitResult(best_vars, best_val, history)

    def _dump_images(self, batch: dict, epoch: int, batch_idx: int) -> None:
        """Debug dumps of batch element 0: prediction, sparse input and GT,
        each min-max normalised to an 8-bit grayscale PNG."""
        os.makedirs(self.cfg.image_dir, exist_ok=True)
        self.model.eval()
        pred = self.task.predict(batch)
        stem = os.path.join(self.cfg.image_dir, f"{self.cfg.run_name}_e{epoch}_b{batch_idx}")
        for suffix, t in (("_out", pred), ("_sparse", batch["depth"]), ("_gt", batch["gt"])):
            save_depth_png(t[0].float().cpu().numpy(), stem + suffix + ".png")


def save_depth_png(depth: np.ndarray, path: str) -> None:
    """Write a depth map (singleton axes squeezed) as a min-max normalised
    8-bit grayscale PNG, with the standard library's zlib only."""
    d = np.asarray(depth, np.float32)
    d = d.reshape([s for s in d.shape if s != 1] or [1, 1])
    lo, hi = float(d.min()), float(d.max())
    img = ((d - lo) / (hi - lo) * 255 if hi > lo else np.zeros_like(d)).astype(np.uint8)
    raw = b"".join(b"\x00" + row.tobytes() for row in img)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))
