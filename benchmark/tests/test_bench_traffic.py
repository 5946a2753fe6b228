"""The traffic generator: the same seed gives the same bytes, another seed
others, and every row and frame differs."""
from __future__ import annotations

import json

import numpy as np

from benchmark import generate, weights
from conftest import REPO

SEED = 2**31 + 99


def _traffic(name):
    return json.loads((REPO / "benchmark" / "traffic" / f"{name}.json").read_text())


def test_frames_repeat_by_seed():
    p = {**_traffic("kitti-drive-replay")["frames"], "ring": 3}
    a, b, c = (generate.frames(p, 112, 64, s) for s in (SEED, SEED, SEED + 1))
    for fa, fb, fc in zip(a, b, c):
        for x, y, z in zip(fa, fb, fc):
            assert x.tobytes() == y.tobytes() and x.tobytes() != z.tobytes()
    rgb, depth = a[0][0], a[0][1]
    assert rgb.dtype == np.uint8 and rgb.shape == (112, 64, 3) and depth.dtype == np.float32
    assert depth[: int(p["horizon"] * 112)].max() == 0  # nothing above the horizon
    assert abs((depth > 0).mean() - p["density"]) < 0.02 and depth.max() <= p["depth_max_m"]
    assert len({f[1].tobytes() for f in a} | {f[3].tobytes() for f in a}) == 6


def test_batches_repeat_by_seed_and_rows_differ():
    p = {**_traffic("kitti-step1-batches")["batches"], "ring": 3}
    a, b, c = (generate.batches(p, 4, 64, 96, s) for s in (SEED, SEED, SEED + 1))
    for x, y, z in zip(a, b, c):
        for k in ("depth", "gt"):
            assert x[k].tobytes() == y[k].tobytes() != z[k].tobytes()
    rows = {r.tobytes() for batch in a for r in batch["gt"]}
    assert len(rows) == 12 and all(batch["gt"].min() > 0.01 for batch in a)


def test_weights_repeat_by_seed():
    shapes = {"a.conv.weight": (4, 2, 3, 3), "a.conv.bias": (4,), "a.bn.running_var": (4,), "nconv1.weight": (8, 1, 5, 5)}
    a, b, c = (weights.make(shapes, s, "cpu") for s in (SEED, SEED, SEED + 1))
    for k in shapes:
        assert a[k].shape == shapes[k] and a[k].equal(b[k]) and not a[k].equal(c[k])
    assert a["a.bn.running_var"].min() >= 0.5 and a["nconv1.weight"].min() >= 0
    assert a["a.conv.weight"].abs().max() <= 1 / np.sqrt(18)
