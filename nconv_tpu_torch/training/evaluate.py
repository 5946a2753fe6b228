"""Evaluation: run a model over a dataset and report the depth-completion
metric set (the JAX package's ``nconv_tpu/training/evaluate.py``)."""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from .. import metrics
from ..models import GuidedDepthNet, NConvUNet


def evaluate(
    predict_fn: Callable[[dict], torch.Tensor],
    loader: Iterable[dict],
    *,
    max_batches: int | None = None,
) -> dict[str, float]:
    """Each metric of :func:`~nconv_tpu_torch.metrics.compute_all`,
    averaged over the loader's batches (each batch's metric counts once).
    ``predict_fn(batch) -> depth`` (B, H, W, 1); batches (numpy arrays or
    tensors) must carry ``gt``."""
    sums: dict[str, float] = {}
    n = 0
    for i, batch in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        pred = predict_fn(batch)
        m = metrics.compute_all(pred, torch.as_tensor(batch["gt"], device=pred.device))
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    if n == 0:
        raise ValueError("empty loader")
    return {k: v / n for k, v in sums.items()}


def _on(model, a) -> torch.Tensor:
    return torch.as_tensor(a, device=next(model.parameters()).device)


def make_unguided_predict(model: NConvUNet):
    """``predict(batch)``: step 1's dense depth of ``batch["depth"]`` under
    ``torch.no_grad()``, on the model's device."""

    @torch.no_grad()
    def predict(batch):
        return model(_on(model, batch["depth"]))[0]

    return predict


def make_guided_predict(model: GuidedDepthNet):
    """``predict(batch)``: the guided net's finest scale, single stream (the
    reference feeds one input to both streams and reads stream 0, which the
    single-stream forward equals), in eval mode (BN on its running
    statistics) under ``torch.no_grad()``, on the model's device. The
    model's own mode is restored on return, as JAX's predict is a pure
    function of the variables."""

    @torch.no_grad()
    def predict(batch):
        training = model.training
        model.eval()
        try:
            return model(_on(model, batch["rgb"]), _on(model, batch["depth"]))[0][-1]
        finally:
            model.train(training)

    return predict
