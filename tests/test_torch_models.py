"""Models of the PyTorch port against the JAX models, on the CPU.

JAX variables (random init, random BN statistics) go through
``from_jax_variables`` into the port; both run the same numpy inputs.
Bars (relative RMSE): step 1 f32 <= 1e-5; guided ``forward``/``export``
f32 <= 1e-4; the port's mixed schedule (bf16 feature convs, f32 step 1 and
depth) <= 1e-3 against f32 JAX; BN folding equal to 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nconv_tpu.models import GuidedDepthNet as JGuided
from nconv_tpu.models import NConvUNet as JUNet
from nconv_tpu.models.fold import fold_batchnorm_variables
from nconv_tpu_torch.convert import from_jax_unguided_variables, from_jax_variables
from nconv_tpu_torch.models import (
    GuidedDepthNet,
    NConvUNet,
    fold_batchnorm_state,
    maybe_fold,
    resolve_device,
)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def sparse_depth(rng, b, h, w):
    return (rng.random((b, h, w, 1)) * 80 * (rng.random((b, h, w, 1)) < 0.1)).astype(np.float32)


def rgb_frame(rng, b, h, w):
    return (rng.random((b, h, w, 3)) * 255).astype(np.float32)


def random_variables(model, *example_args, seed=0):
    """A JAX variable tree of ``model``'s shapes filled from numpy: conv
    kernels U(+-1/sqrt(fan_in)), NConv kernels U[0, 1) (raw, before
    softplus), every other leaf (biases, BN scale/bias/mean/var) U[0.5, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *example_args))

    def fill(path, s):
        names = [p.key for p in path]
        if names[-1] != "kernel":
            return jnp.asarray((rng.random(s.shape) * 0.5 + 0.5).astype(np.float32))
        if any(n.startswith("nconv") for n in names):
            return jnp.asarray(rng.random(s.shape).astype(np.float32))
        bound = 1 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray(((rng.random(s.shape) * 2 - 1) * bound).astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def guided_vars():
    z3, z1 = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 16, 16, 1))
    return random_variables(JGuided(), z3, z1, z3, z1, seed=5)


def port(variables, **kw):
    m = GuidedDepthNet(device="cpu", **kw)
    m.load_state_dict(from_jax_variables(variables))
    return m


def test_param_counts_match_jax():
    m = GuidedDepthNet(device="cpu")
    assert sum(p.numel() for p in m.step1.parameters()) == 10_129
    assert sum(p.numel() for n, p in m.named_parameters() if not n.startswith("step1.")) == 978_336


@pytest.mark.parametrize("b,hw", [(1, (48, 64)), (2, (32, 96))])
def test_unguided_matches_jax(b, hw):
    rng = np.random.default_rng(0)
    d = sparse_depth(rng, b, *hw)
    jm = JUNet()
    v = random_variables(jm, jnp.zeros((1, 16, 16, 1)), seed=b)
    want = jax.jit(jm.apply)(v, jnp.asarray(d))
    m = NConvUNet(device="cpu")
    m.load_state_dict(from_jax_unguided_variables(v))
    with torch.no_grad():
        fused = m(torch.from_numpy(d))  # the serving graph
    trainable = m(torch.from_numpy(d))  # grad enabled: the training graph
    for got in (fused, trainable):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert rel(g.detach().numpy(), w) <= 1e-5


def test_unguided_rejects_sizes_off_the_pyramid():
    with pytest.raises(ValueError):
        NConvUNet(device="cpu")(torch.zeros(1, 36, 64, 1))


@pytest.mark.parametrize("two_stream", [True, False])
def test_guided_forward_matches_jax(guided_vars, two_stream):
    rng = np.random.default_rng(1)
    r0, d0 = rgb_frame(rng, 1, 48, 64), sparse_depth(rng, 1, 48, 64)
    r1, d1 = (rgb_frame(rng, 1, 48, 64), sparse_depth(rng, 1, 48, 64)) if two_stream else (None, None)
    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.from_numpy(a)
    want = jax.jit(JGuided().apply)(guided_vars, J(r0), J(d0), J(r1), J(d1))
    got = port(guided_vars)(T(r0), T(d0), T(r1), T(d1))
    assert (got[1] is None) == (not two_stream)
    for gs, ws in zip(got, want):
        if ws is None:
            continue
        assert len(gs) == 4
        for g, w in zip(gs, ws):
            assert g.shape == w.shape
            assert rel(g.detach().numpy(), w) <= 1e-4


@pytest.fixture(scope="module")
def export_case(guided_vars):
    """96x128 (the 45/45/20 border leaves rows 45..50 of a 96-row frame)."""
    rng = np.random.default_rng(2)
    r0, d0, r1, d1 = (rgb_frame(rng, 1, 96, 128), sparse_depth(rng, 1, 96, 128),
                      rgb_frame(rng, 1, 96, 128), sparse_depth(rng, 1, 96, 128))
    folded = fold_batchnorm_variables(guided_vars)
    args = [jnp.asarray(a) for a in (r0, d0, r1, d1)]
    want = jax.jit(lambda v, *a: JGuided(fold_bn=True).apply(v, *a, method=JGuided.export))(folded, *args)
    return [torch.from_numpy(a) for a in (r0, d0, r1, d1)], want


def test_guided_export_matches_jax(guided_vars, export_case):
    inputs, want = export_case
    for model in (port(guided_vars), maybe_fold(port(guided_vars), from_jax_variables(guided_vars))):
        if isinstance(model, tuple):
            model, state = model
            model.load_state_dict(state)
        got = model.export(*inputs)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(np.asarray(w)[:, 45:51, 20:]).sum() > 0
            assert (g[:, :45] == 0).all() and (g[:, 51:] == 0).all() and (g[:, :, :20] == 0).all()
            assert rel(g.numpy(), w) <= 1e-4


def test_mixed_schedule_matches_f32_jax(guided_vars, export_case):
    inputs, want = export_case
    m, state = maybe_fold(GuidedDepthNet(device="cpu", dtype=torch.bfloat16),
                          from_jax_variables(guided_vars))
    m.load_state_dict(state)
    got = m.export(*inputs)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32  # depth stays f32
        assert rel(g.numpy(), w) <= 1e-3


def test_mixed_model_rounds_feature_weights_once(guided_vars):
    """The mixed serving model (BN folded) holds its conv weights at bf16
    values (as f32 tensors) after loading; step 1 and the f32 model keep
    theirs exact. (The unfolded model, which trains, keeps f32 masters:
    tests/test_torch_bf16_training.py.)"""
    state = fold_batchnorm_state(from_jax_variables(guided_vars))
    f32 = GuidedDepthNet(device="cpu", fold_bn=True)
    f32.load_state_dict(state)
    mixed = GuidedDepthNet(device="cpu", dtype=torch.bfloat16, fold_bn=True)
    mixed.load_state_dict(state)
    for (name, p), (_, q) in zip(f32.state_dict().items(), mixed.state_dict().items()):
        assert p.dtype == q.dtype == torch.float32, name
        assert torch.equal(p, state[name]), name
        conv = name.startswith(("rgb_encoder", "fuse"))
        assert torch.equal(q, p.bfloat16().float() if conv else p), name
    assert not torch.equal(mixed.fuse3.conv.conv.weight, f32.fuse3.conv.conv.weight)


def test_fold_matches_jax(guided_vars):
    want = from_jax_variables(fold_batchnorm_variables(guided_vars))
    got = fold_batchnorm_state(from_jax_variables(guided_vars))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert float((got[k] - want[k]).abs().max()) <= 1e-6, k
    # and the folded state loads into the folded model
    GuidedDepthNet(device="cpu", fold_bn=True).load_state_dict(got)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GuidedDepthNet()
