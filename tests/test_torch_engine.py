"""The port's StreamingEngine against the JAX StreamingEngine on the CPU:
the same u8 RGB / float depth frames (u16 wire) and the same weights give
the same border-masked depth, relative RMSE <= 1e-4. And the request
path's parallel encode: ``stage()``'s wire bitwise the per-stream one, one
``engine.encode`` span and one ``engine.encode_parallel`` a request and
none in ``run()``, the other wires and inputs stream by stream, a forked
child's encode."""
import multiprocessing
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nconv_tpu.data import native
from nconv_tpu.models import GuidedDepthNet as JGuided
from nconv_tpu.runtime import StreamingEngine as JEngine
from nconv_tpu_torch.convert import from_jax_variables
from nconv_tpu_torch.data import native as tnative
from nconv_tpu_torch.models import GuidedDepthNet
from nconv_tpu_torch.runtime import StreamingEngine, benchmark, encode_depth_wire, tracing
from nconv_tpu_torch.runtime.streaming import _Slot

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


# -- the request path's parallel encode ------------------------------------------

@pytest.fixture(scope="module")
def plain_state():
    return GuidedDepthNet(device="cpu").state_dict()


def wire_arrays(eng, wire):
    """The staged wire's arrays by (stream, name), as numpy."""
    return {k: v.copy() for k, v in eng._layout.numpy_views(wire.numpy()).items()}


def test_stage_s_parallel_wire_is_the_serial_one(plain_state):
    eng = StreamingEngine(plain_state, height=H, width=W, device="cpu")
    for seed in (0, 1):
        f = tuple(frames(seed))
        parallel = wire_arrays(eng, eng.stage(*f))
        slot = _Slot(eng._layout, eng.device)
        eng._stage_into(slot, f, 0, parallel=False)  # run()'s staging workers' form
        serial = wire_arrays(eng, slot.host)
        assert parallel.keys() == serial.keys()
        for k in parallel:
            np.testing.assert_array_equal(parallel[k], serial[k])


def test_the_parallel_encode_counts_requests_and_stages_not_run(plain_state):
    eng = StreamingEngine(plain_state, height=H, width=W, device="cpu")
    f = tuple(frames(0))
    tracing.enable()
    try:
        list(eng.run([f] * 3))
        assert "engine.encode_parallel" not in tracing.counters()  # run()'s workers encode stream by stream
        tracing.clear()
        eng(*f)
        eng(*f)
        eng.replay(eng.stage(*f))
        assert tracing.counters()["engine.encode_parallel"] == 3
        encodes = [s.frame for s in tracing.collected() if s.name == "engine.encode"]
        assert len(encodes) == len(set(encodes)) == 3  # one span a request
    finally:
        tracing.disable()
        tracing.clear()


def expected_wire(eng, f):
    """Each stream's wire arrays as the per-stream encoders write them."""
    out = {}
    for s in (0, 1):
        rgb, d = f[2 * s], f[2 * s + 1]
        if eng.rgb_wire == "dense":
            out[(s, "rgb")] = np.clip(rgb, 0, 255).astype(eng.rgb_wire_dtype)[None]
        else:
            enc = tnative.encode_yuv420 if eng.rgb_wire == "yuv420" else tnative.encode_yuv422
            for name, plane in zip("yuv", enc(np.clip(rgb, 0, 255).astype(np.uint8))):
                out[(s, name)] = plane[None]
        if eng.depth_wire == "coo":
            out[(s, "idx")], out[(s, "val")], _ = tnative.encode_depth_coo(d, eng.coo_capacity)
        elif eng.depth_wire_dtype == np.uint16:
            out[(s, "depth")] = tnative.encode_depth_wire(d)[None, :, :, None]
        else:
            out[(s, "depth")] = d[None, :, :, None]
    return out


@pytest.mark.parametrize("wire,float_rgb", [
    (dict(rgb_wire="yuv420"), False), (dict(rgb_wire="yuv422"), False), (dict(depth_wire="coo"), False),
    (dict(depth_wire_dtype=np.float32), False), (dict(rgb_wire_dtype=np.float32), False), ({}, True)])
def test_other_wires_and_inputs_keep_the_per_stream_encode(plain_state, wire, float_rgb):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # yuv420's accuracy warning
        eng = StreamingEngine(plain_state, height=H, width=W, device="cpu", **wire)
    f = list(frames(2))
    if float_rgb:
        f[0], f[2] = f[0].astype(np.float32) + 0.25, f[2].astype(np.float32) - 0.5
    tracing.enable()
    try:
        got = wire_arrays(eng, eng.stage(*f))
        assert "engine.encode_parallel" not in tracing.counters()
        assert sum(s.name == "engine.encode" for s in tracing.collected()) == 2  # one a stream
    finally:
        tracing.disable()
        tracing.clear()
    want = expected_wire(eng, f)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def encode_tiny_frame(seed, h=5, w=7):
    """The parallel call on 3 threads on a tiny frame, checked against the
    per-stream encoders (a mismatch raises)."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    d = (rng.random((h, w)) * 300).astype(np.float32)
    out = tuple(np.empty(shape, dt) for shape, dt in (((1, h, w, 3), np.uint8), ((1, h, w, 1), np.uint16)) * 2)
    tnative.encode_frame_dense(rgb, d, rgb, d, out, threads=3, bands=h)
    if not ((out[2][0] == rgb).all() and (out[3] == tnative.encode_depth_wire(d[None, :, :, None])).all()):
        raise ValueError("the forked child's frame differs from the per-stream encoders")


def test_a_forked_child_encodes_and_exits(plain_state):
    """The library's pool is rebuilt in a child forked after the parent's
    pool ran: the child's call returns, and the child exits."""
    eng = StreamingEngine(plain_state, height=H, width=W, device="cpu")
    eng.stage(*frames(0))  # the engine's parallel call
    encode_tiny_frame(0)  # the parent's pool with two workers
    ctx = multiprocessing.get_context("fork")
    child = ctx.Process(target=encode_tiny_frame, args=(1,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", (DeprecationWarning, RuntimeWarning))  # fork in a threaded process
        child.start()
    child.join(60)
    alive = child.is_alive()
    if alive:
        child.kill()
    assert not alive and child.exitcode == 0
