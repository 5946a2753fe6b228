"""In-memory synthetic sparse-depth frames (the JAX CLI's synthetic
dataset, ``nconv_tpu/cli.py:_SyntheticDataset``): smooth depth under an 8%
Bernoulli mask, random RGB, all from one numpy seed."""
from __future__ import annotations

import numpy as np


class SyntheticDataset:
    def __init__(self, n: int = 32, height: int = 480, width: int = 640, seed: int = 0):
        self.n = n
        rng = np.random.default_rng(seed)
        i, j = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        self.truth = (
            2 + np.sin(i / 60)[None] * rng.random((n, 1, 1)) + np.cos(j / 80)[None]
        ).astype(np.float32)[..., None]
        self.masks = (rng.random((n, height, width, 1)) < 0.08).astype(np.float32)
        self.rgb = rng.random((n, height, width, 3)).astype(np.float32) * 255

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return {"rgb": self.rgb[i], "depth": self.truth[i] * self.masks[i], "gt": self.truth[i]}


def bench_batch(b: int, height: int, width: int, seed: int = 0) -> dict:
    """The step-1 part of the JAX bench's synthetic training batch
    (``nconv_tpu/cli.py``, ``_bench_train``), NHWC numpy: smooth depth
    2 + sin(i/40) + cos(j/60) under a 6% Bernoulli mask, and its dense
    ground truth."""
    rng = np.random.default_rng(seed)
    truth = np.fromfunction(
        lambda n, i, j, c: 2 + np.sin(i / 40) + np.cos(j / 60), (b, height, width, 1)
    ).astype(np.float32)
    rng.random((b, height, width, 3))  # the batch's RGB: drawn first, as the bench draws it
    return {"depth": (truth * (rng.random((b, height, width, 1)) < 0.06)).astype(np.float32), "gt": truth}
