"""The port's StreamingEngine against the JAX StreamingEngine on the CPU:
the same u8 RGB / float depth frames (u16 wire) and the same weights give
the same border-masked depth, relative RMSE <= 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nconv_tpu.data import native
from nconv_tpu.models import GuidedDepthNet as JGuided
from nconv_tpu.runtime import StreamingEngine as JEngine
from nconv_tpu_torch.convert import from_jax_variables
from nconv_tpu_torch.runtime import StreamingEngine, benchmark, encode_depth_wire

H, W = 96, 128


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def jax_variables():
    """Random JAX ``GuidedDepthNet`` variables (positive nconv kernels, BN
    statistics near 1) from a seed."""
    rng = np.random.default_rng(3)
    z3, z1 = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 16, 16, 1))
    shapes = jax.eval_shape(lambda: JGuided().init(jax.random.key(0), z3, z1, z3, z1))

    def fill(path, s):
        names = [p.key for p in path]
        if names[-1] != "kernel":
            return (rng.random(s.shape) * 0.5 + 0.5).astype(np.float32)
        if any(n.startswith("nconv") for n in names):
            return rng.random(s.shape).astype(np.float32)
        bound = 1 / np.sqrt(np.prod(s.shape[:-1]))
        return ((rng.random(s.shape) * 2 - 1) * bound).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def variables():
    return jax_variables()


def frames(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        rgb = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        d = (rng.random((H, W)) * 80 * (rng.random((H, W)) < 0.06)).astype(np.float32)
        out += [rgb, d]
    return out


def test_engine_matches_jax_engine(variables):
    jeng = JEngine(variables, height=H, width=W)
    peng = StreamingEngine(from_jax_variables(variables), height=H, width=W, device="cpu")
    for seed in (0, 1):
        f = frames(seed)
        want = jeng(*f)
        got = peng(*f)
        for g, w in zip(got, want):
            assert g.shape == (1, H, W, 1)
            assert (g[:, :45] == 0).all()
            assert rel(g.numpy(), w) <= 1e-4


def test_depth_wire_matches_jax_encoder():
    rng = np.random.default_rng(4)
    d = np.concatenate([rng.random(1000) * 300, [-1.0, 0.0, 255.99, 256.0, 1e6]]).astype(np.float32)
    np.testing.assert_array_equal(encode_depth_wire(d), native.encode_depth_wire(d, 256.0))


def test_engine_rejects_wrong_geometry(variables):
    eng = StreamingEngine(from_jax_variables(variables), height=H, width=W, device="cpu")
    rgb, d, _, _ = frames(0)
    with pytest.raises(ValueError):
        eng(rgb[:50], d, rgb, d)


def test_benchmark_on_cpu_uses_the_host_clock(variables):
    eng = StreamingEngine(from_jax_variables(variables), height=H, width=W, device="cpu",
                          compute_dtype=torch.bfloat16)
    eng.warmup()
    stats = benchmark(eng, n_frames=4, warmup=1, window=2)
    assert set(stats) == {"device", "synced", "e2e"}
    for s in stats.values():
        assert s.clock == "host" and s.p50_ms > 0
    assert stats["synced"].n_frames == stats["e2e"].n_frames == 4
    assert eng.wire_bytes_per_frame == 2 * H * W * 5
