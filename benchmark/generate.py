"""The general traffic generator: host inputs from a traffic file's
parameters and a seed. The same seed gives the same bytes.

``frames``: a ring of two-stream KITTI-like requests, each ``(rgb0, depth0,
rgb1, depth1)``: HWC uint8 RGB (smooth colour fields under uniform noise)
and HW float32 sparse depth like projected lidar returns: nothing above
the horizon, a ramp from ``depth_min_m`` at the bottom row to
``depth_max_m`` at the horizon with lateral structure, kept on a Bernoulli
mask that gives ``density`` of the whole frame.

``batches``: a ring of step-1 training batches ``{"depth", "gt"}`` (NHWC
float32), a copy of ``nconv_tpu_torch/data/synthetic.py:bench_batch``: a
smooth ground truth ``base + a sin(i / 40 + p) + b cos(j / 60 + q)`` under a
Bernoulli mask of ``density``, where each row draws its own amplitudes and
phases so that no two rows are alike.
"""
from __future__ import annotations

import numpy as np


def rng_of(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


def _frame_stream(rng, p, height, width):
    i = np.arange(height, dtype=np.float32)[:, None]
    j = np.arange(width, dtype=np.float32)[None, :]
    horizon = int(p["horizon"] * height)
    t = np.clip((height - 1 - i) / max(height - 1 - horizon, 1), 0, 1)
    period, phase = rng.uniform(30, 90), rng.uniform(0, 2 * np.pi)
    lateral = 0.75 + 0.25 * np.sin(j / period + phase)
    d = p["depth_min_m"] + (p["depth_max_m"] - p["depth_min_m"]) * t * t * lateral
    keep = (i >= horizon) & (rng.random((height, width), dtype=np.float32) < p["density"] / (1 - p["horizon"]))
    depth = np.where(keep, d, 0).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, (2, 3)).astype(np.float32)
    base = 128 + 90 * np.sin(i[..., None] / 37 + ph[0]) * np.cos(j[..., None] / 53 + ph[1])
    noise = rng.integers(-24, 25, (height, width, 3), dtype=np.int16)
    rgb = np.clip(base + noise, 0, 255).astype(np.uint8)
    return rgb, depth


def frames(p: dict, height: int, width: int, seed: int) -> list[tuple]:
    """``p["ring"]`` distinct two-stream requests."""
    rng = rng_of(seed, 1)
    out = []
    for _ in range(p["ring"]):
        rgb0, d0 = _frame_stream(rng, p, height, width)
        rgb1, d1 = _frame_stream(rng, p, height, width)
        out.append((rgb0, d0, rgb1, d1))
    return out


def batches(p: dict, batch: int, height: int, width: int, seed: int) -> list[dict]:
    """``p["ring"]`` distinct training batches of ``batch`` rows."""
    rng = rng_of(seed, 2)
    i = np.arange(height, dtype=np.float32)[None, :, None, None]
    j = np.arange(width, dtype=np.float32)[None, None, :, None]
    lo, hi = p["amp"]
    out = []
    for _ in range(p["ring"]):
        a, b = (rng.uniform(lo, hi, (batch, 1, 1, 1)).astype(np.float32) for _ in range(2))
        pi, pj = (rng.uniform(0, 2 * np.pi, (batch, 1, 1, 1)).astype(np.float32) for _ in range(2))
        gt = (p["base_m"] + a * np.sin(i / 40 + pi) + b * np.cos(j / 60 + pj)).astype(np.float32)
        mask = rng.random((batch, height, width, 1), dtype=np.float32) < p["density"]
        out.append({"depth": np.where(mask, gt, 0).astype(np.float32), "gt": gt})
    return out
