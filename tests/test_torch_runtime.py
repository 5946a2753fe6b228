"""The port's serving runtime against the JAX package's on the CPU: every
wire and constructor option of ``StreamingEngine`` (rel RMSE <= 1e-4
against the JAX engine in f32; the mixed schedule no further from JAX f32
than twice JAX's own mixed engine), the COO wire bitwise equal to the dense
uint16 wire, ``run()``, the three clocks of ``benchmark``,
``benchmark_throughput``, ``Step1Unguided``, the wire encoders (bitwise
equal to ``nconv_tpu.data.native``'s), and the device tables built once.
(The graph's own test, which needs the card, is tests/test_torch_graph.py.)"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nconv_tpu.data import native
from nconv_tpu.models import GuidedDepthNet as JGuided
from nconv_tpu.models import Step1Unguided as JStep1
from nconv_tpu.runtime import StreamingEngine as JEngine
from nconv_tpu_torch.convert import from_jax_variables
from nconv_tpu_torch.models import GuidedDepthNet, Step1Unguided, border_mask
from nconv_tpu_torch.ops import resize
from nconv_tpu_torch.ops.tables import TABLES
from nconv_tpu_torch.runtime import StreamingEngine, benchmark, benchmark_throughput, wires
from test_torch_engine import jax_variables, rel

H, W = 96, 128


@pytest.fixture(scope="module")
def variables():
    return jax_variables()


@pytest.fixture(scope="module")
def state(variables):
    return from_jax_variables(variables)


def float_frames(seed, n=1):
    """``n`` two-stream frames: float RGB in [0, 255) (every wire encodes
    it), float sparse depth (6% of the pixels, up to 80 m)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = []
        for _ in range(2):
            f.append((rng.random((H, W, 3)) * 255).astype(np.float32))
            f.append((rng.random((H, W)) * 80 * (rng.random((H, W)) < 0.06)).astype(np.float32))
        out.append(tuple(f))
    return out


# case: (the JAX engine's options, the port's); the port's model is built
# on the CPU where the JAX one is given
CASES = {
    "dense_u16": ({}, {}),
    "f32_depth": (dict(depth_wire_dtype=np.float32), dict(depth_wire_dtype=np.float32)),
    "f32_rgb": (dict(rgb_wire_dtype=np.float32), dict(rgb_wire_dtype=np.float32)),
    "coo": (dict(depth_wire="coo"), dict(depth_wire="coo")),
    "yuv420": (dict(rgb_wire="yuv420"), dict(rgb_wire="yuv420")),
    "yuv422": (dict(rgb_wire="yuv422"), dict(rgb_wire="yuv422")),
    "unfolded": (dict(fold_bn=False), dict(fold_bn=False)),
    "identity_step1": (dict(model=JGuided(step1_pos_fn="identity")),
                       dict(model=GuidedDepthNet(step1_pos_fn="identity", device="cpu"))),
}
JAX_MIXED = dict(compute_dtype=jnp.bfloat16, model=JGuided(dtype=jnp.bfloat16, step1_dtype=jnp.float32))


@pytest.fixture(scope="module")
def jax_engines(variables):
    """JAX engines by name, each built (and compiled) once per module."""
    made = {}

    def get(name, **kw):
        if name not in made:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # yuv420's accuracy warning
                made[name] = JEngine(variables, height=H, width=W, **kw)
        return made[name]

    return get


def port_engine(state, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return StreamingEngine(state, height=H, width=W, device="cpu", **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine_on_each_wire(case, state, jax_engines):
    jkw, pkw = CASES[case]
    jeng = jax_engines(case, **jkw)
    peng = port_engine(state, **pkw)
    assert peng.wire_bytes_per_frame == jeng.wire_bytes_per_frame
    for f in float_frames(0, 2):
        for got, want in zip(peng(*f), jeng(*f)):
            assert got.shape == (1, H, W, 1) and got.dtype == torch.float32
            assert (got[:, :45] == 0).all()
            assert rel(got.numpy(), want) <= 1e-4, case


@pytest.mark.parametrize("wire", ["dense", "yuv422_coo"])
def test_mixed_schedule_within_twice_jax_mixed(wire, state, jax_engines):
    kw = {} if wire == "dense" else dict(rgb_wire="yuv422", depth_wire="coo")
    j32 = jax_engines("dense_u16" if wire == "dense" else wire, **kw)
    jmixed = jax_engines("mixed_" + wire, **kw, **JAX_MIXED)
    mixed = port_engine(state, compute_dtype=torch.bfloat16, **kw)
    for f in float_frames(1, 2):
        want = np.concatenate(j32(*f))
        jax_dist = rel(np.concatenate(jmixed(*f)), want)
        assert 0 < rel(torch.cat(mixed(*f)).numpy(), want) <= 2 * jax_dist


def noisy_frame(seed):
    """Smooth depth under a 5% mask and a smooth RGB frame with noise of
    sigma 20 on every pixel (as ``chip_smoke.py``'s ``synthetic_frames``)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = ((5 + 40 * yy / H) * (rng.random((H, W)) < 0.05)).astype(np.float32)
    base = np.stack([xx / W, yy / H, 0.5 + 0.5 * np.sin(xx / 40.0)], -1) * 200
    rgb = np.clip(base + rng.normal(0, 20, (H, W, 3)), 0, 255).astype(np.uint8)
    return rgb, depth, rgb, depth


@pytest.mark.parametrize("wire", ["yuv420", "yuv422"])
def test_yuv_wire_distance_from_dense_is_the_jax_engines(wire, state, jax_engines):
    """On noisy frames the YUV wires stand above the 1e-3 bar of natural
    content; the JAX engine stands as far as the port (within 10%)."""
    f = noisy_frame(9)
    dist = {}
    for name, engines in (("jax", (jax_engines("dense_u16"), jax_engines(wire, rgb_wire=wire))),
                          ("port", (port_engine(state), port_engine(state, rgb_wire=wire)))):
        dense, yuv = (np.concatenate([np.asarray(o) for o in e(*f)]) for e in engines)
        dist[name] = rel(yuv, dense)
    assert dist["jax"] > 1e-3 and abs(dist["port"] / dist["jax"] - 1) <= 0.1, dist


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "mixed"])
def test_coo_wire_is_bitwise_the_dense_wire(dtype, state):
    dense = port_engine(state, compute_dtype=dtype)
    coo = port_engine(state, compute_dtype=dtype, depth_wire="coo")
    assert coo.coo_capacity == 1536 and coo.wire_bytes_per_frame < dense.wire_bytes_per_frame
    for f in float_frames(2, 2):
        for a, b in zip(coo(*f), dense(*f)):
            assert torch.equal(a, b)
    assert coo.coo_dropped_points == 0


def test_coo_overflow_counts_and_warns_once(state):
    eng = port_engine(state, depth_wire="coo", coo_capacity=64)
    rgb, _, _, _ = float_frames(3)[0]
    d = np.ones((H, W), np.float32)  # fully dense: 64 points kept a stream
    with pytest.warns(UserWarning, match="COO depth wire capacity"):
        out = eng(rgb, d, rgb, d)
    assert eng.coo_dropped_points == 2 * (H * W - 64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng(rgb, d, rgb, d)
    assert eng.coo_dropped_points == 4 * (H * W - 64)
    assert all(torch.isfinite(o).all() for o in out)


@pytest.mark.parametrize("stage_workers", [1, 2])
def test_run_keeps_order_and_equals_single_calls(stage_workers, state):
    eng = port_engine(state, depth_wire="coo")
    frames = float_frames(4, 6)
    sunk = []
    outs = list(eng.run(iter(frames), depth=2, stage_ahead=3, stage_workers=stage_workers,
                        sink=lambda a, b: sunk.append(a)))
    assert len(outs) == len(sunk) == 6
    for f, out, s in zip(frames, outs, sunk):
        ref = eng(*f)
        assert s is out[0]
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert not torch.equal(outs[0][0], outs[1][0])


def test_benchmark_returns_three_clocks_on_the_host(state):
    eng = port_engine(state, rgb_wire="yuv422")
    stats = benchmark(eng, n_frames=4, warmup=1, window=2)
    assert set(stats) == {"device", "synced", "e2e"}
    for s in stats.values():
        d = s.as_dict()
        assert d["clock"] == "host" and d["p50_ms"] > 0 and d["fps"] > 0
    assert stats["device"].n_frames == 3
    assert "e2e" not in benchmark(eng, n_frames=4, warmup=1, window=2, include_e2e=False)


def test_benchmark_throughput_on_cpu(state):
    fps = benchmark_throughput(state, height=H, width=W, batch=2, n_iters=1, device="cpu")
    assert fps > 0


@pytest.mark.parametrize("streams", [1, 2])
def test_step1_unguided_matches_jax(streams):
    rng = np.random.default_rng(5)
    depths = [(rng.random((1, H, W, 1)) * 80 * (rng.random((1, H, W, 1)) < 0.06)).astype(np.float32)
              for _ in range(streams)]
    jmodel = JStep1()
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 16, 16, 1)))
    variables = jax.tree_util.tree_map(lambda s: rng.random(s.shape).astype(np.float32), shapes)
    want = jax.jit(jmodel.apply)(variables, *map(jnp.asarray, depths))
    model = Step1Unguided(device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, depths))
    assert got.shape == (streams, H, W, 1)
    assert rel(got.numpy(), want) <= 1e-5


EDGES = np.array([-1.0, 0.0, 255.99, 256.0, 1e6], np.float32)


@pytest.mark.parametrize("encoder", ["depth_wire", "depth_coo", "yuv420", "yuv422"])
def test_wire_encoders_match_jax_package(encoder, monkeypatch):
    """Bitwise against ``nconv_tpu.data.native``'s numpy forms (the C
    depth encoders are bitwise the same; the C YUV encoders round in
    integers and may differ by one step, as tests/test_runtime.py pins)."""
    rng = np.random.default_rng(6)
    if encoder.startswith("depth"):
        d = (rng.random((32, 48)) * 300 * (rng.random((32, 48)) < 0.3)).astype(np.float32)
        d.ravel()[: EDGES.size] = EDGES
        if encoder == "depth_wire":
            want = native.encode_depth_wire(d, 256.0)
            out = np.empty(d.shape, np.uint16)
            assert wires.encode_depth_wire(d, 256.0, out=out) is out
            got = [out]
            want = [want]
        else:
            for cap in (1024, 100):  # roomy and overflowing
                want = native.encode_depth_coo(d, cap)
                got = wires.encode_depth_coo(d, cap, out=(np.full((1, cap), 7, np.int32),
                                                          np.full((1, cap), 7, np.uint16)))
                assert got[2] == want[2]
                for a, b in zip(got[:2], want[:2]):
                    np.testing.assert_array_equal(a, b)
            return
    else:
        rgb = (rng.random((32, 48, 3)) * 256).astype(np.uint8)
        rgb[0, :5] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255]]
        c_form = getattr(native, "encode_" + encoder)(rgb)
        monkeypatch.setattr(native, "_load", lambda: None)
        want = getattr(native, "encode_" + encoder)(rgb)
        got = getattr(wires, "encode_" + encoder)(rgb, out=tuple(np.empty_like(p) for p in want))
        for a, b in zip(got, c_form):
            assert np.abs(a.astype(np.int32) - b).max() <= 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- device tables built once -------------------------------------------------

@pytest.mark.parametrize("kind", ["nearest", "align_true", "align_false", "border_mask"])
def test_cached_tables_equal_the_numpy_built_ones(kind):
    if kind == "nearest":
        got = resize._nearest_table(48, 17, torch.device("cpu"))
        want = torch.as_tensor(resize._nearest_indices(48, 17))
        assert torch.equal(got, want)
    elif kind == "border_mask":
        m = np.ones((1, 1, H, W), np.float32)
        m[:, :, :45] = m[:, :, H - 45:] = m[:, :, :, :20] = 0
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(border_mask(H, W, device="cpu", dtype=dt), torch.as_tensor(m, dtype=dt))
    else:
        align = kind == "align_true"
        build = resize._linear_weights_align_true if align else resize._linear_weights_align_false
        for out_size, in_size in ((12, 96), (96, 12), (37, 53)):
            for dt in (torch.float32, torch.bfloat16):
                lo, hi, frac = build(out_size, in_size)
                got = resize._linear_table(out_size, in_size, align, torch.device("cpu"), dt)
                for g, w in zip(got, (torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(frac).to(dt))):
                    assert torch.equal(g, w)


def test_second_export_builds_no_table(state):
    eng = port_engine(state, compute_dtype=torch.bfloat16)
    f = float_frames(7)[0]
    eng(*f)
    builds, hits = TABLES.builds, TABLES.hits
    eng(*f)
    assert TABLES.builds == builds
    assert TABLES.hits - hits >= 2 * 3 + 1  # 3 fusion stages' two axes, the border mask
