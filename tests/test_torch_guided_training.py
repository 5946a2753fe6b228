"""Guided (step-2) training of the PyTorch port against the JAX package, on
the CPU.

Inputs come from numpy seeds and go to both; weights go through
``convert.from_jax_variables``, and so do the JAX gradient trees, so the
conversion of a gradient (the ConvTranspose kernel's re-layout included) is
checked with them. The port runs on CPU tensors, where the kernel wrappers
run their plain versions (the kernels are held against those on the card by
tests/test_torch_kernels.py and chip_smoke.py). Where the JAX function
reaches a Pallas kernel it runs in interpret mode.

Bars: train-mode BN 1e-6; the three conv Functions at the JAX package's own
bars against XLA autodiff (tests/test_s2_diff.py), 1e-5 at stride 1 and
1e-4 for the stride-2 forms; the plain versions of the new gradient forms
against torch's own gradients in f64 at 1e-12; the whole ``GuidedTask``
loss 1e-5 relative and the new BN statistics 1e-5; two epochs of
``Trainer.fit`` 1e-4.

Gradients through train-mode BN cancel: BN's output does not change when
its input shifts or scales per channel, so the cotangent at a BN input sums
to about 0 over each channel, and a conv weight gradient before it is a
small difference of large sums (worst at full resolution, where the RGB
and the skip features carry a large mean). The bias of each RGB encoder
conv, which BN makes redundant, has an exact gradient of 0 and an f32 one
of rounding noise. So each trainable gradient is held to the rule that
chip_smoke.py applies to cancelling gradients on the card: rel RMSE <=
max(1e-4, 4x the port's own f32 error against the port's plain path in
f64); on these inputs that is 1e-4 for
all but the full-resolution stages (up to 3.4e-3). Under adamw a gradient
of rounding noise still moves its parameter by up to the learning rate a
step, so ``Trainer.fit`` runs at lr 1e-4, and its parameters are held to
the same rule: max(1e-4, 4x the f32 fit's distance from the same fit in
f64).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nconv_tpu.models import GuidedDepthNet as JGuided
from nconv_tpu.models.layers import _ChannelBN as JChannelBN
from nconv_tpu.ops.pallas_conv import conv2d_pallas_bhcw_cat
from nconv_tpu.ops.pallas_s2 import conv2d_s2_res_pallas_bhcw, convtranspose2d_s2_pallas_bhcw
from nconv_tpu.training import GuidedTask as JGuidedTask
from nconv_tpu.training import OptimizerConfig as JOptimizerConfig
from nconv_tpu.training import TrainConfig as JTrainConfig
from nconv_tpu.training import Trainer as JTrainer
from nconv_tpu_torch import kernels, ops
from nconv_tpu_torch.convert import from_jax_variables
from nconv_tpu_torch.models import GuidedDepthNet
from nconv_tpu_torch.models.layers import _ChannelBN, stack_shortcut
from nconv_tpu_torch.training import (
    CheckpointManager,
    GuidedTask,
    OptimizerConfig,
    TrainConfig,
    Trainer,
)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def bhcw_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 2, 1, 3))))


def nchw_to_bhcw(t):
    return np.transpose(t.detach().numpy(), (0, 2, 1, 3))


def hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))


def hwio_to_iohw(k):
    """A JAX transpose-conv kernel (kh, kw, cin, cout) as the port's (cin, cout, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (2, 3, 0, 1))))


def leaf(t):
    return t.detach().clone().requires_grad_()


# ---------------------------------------------------------------------------
# Train-mode BatchNorm
# ---------------------------------------------------------------------------

def test_channel_bn_train_mode_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 6, 10, 4)) * 2 + 1).astype(np.float32)  # NHWC
    scale, bias, mean, var = (rng.random(4).astype(np.float32) + 0.5 for _ in range(4))
    cot = rng.standard_normal(x.shape).astype(np.float32)
    bn = JChannelBN(axis=-1)

    def f(xx, s, b):
        return bn.apply({"params": {"scale": s, "bias": b},
                         "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}},
                        xx, use_running_average=False, mutable=["batch_stats"])

    want, vjp, stats = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), has_aux=True)
    want_grads = vjp(jnp.asarray(cot))

    port = _ChannelBN(4, device="cpu").train()
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean), ("running_var", var)):
            getattr(port, name).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_()
    out = port(xt)
    out.backward(torch.from_numpy(np.ascontiguousarray(cot.transpose(0, 3, 1, 2))))
    assert rel(out.detach().numpy().transpose(0, 2, 3, 1), want) <= 1e-6
    assert rel(xt.grad.numpy().transpose(0, 2, 3, 1), want_grads[0]) <= 1e-6
    assert rel(port.weight.grad.numpy(), want_grads[1]) <= 1e-6
    assert rel(port.bias.grad.numpy(), want_grads[2]) <= 1e-6
    assert rel(port.running_mean.numpy(), stats["batch_stats"]["mean"]) <= 1e-6
    assert rel(port.running_var.numpy(), stats["batch_stats"]["var"]) <= 1e-6
    port.eval()  # eval mode reads the running statistics and leaves them
    before = port.running_var.clone()
    with torch.no_grad():
        port(xt)
    assert torch.equal(port.running_var, before)


# ---------------------------------------------------------------------------
# The three conv Functions against the Pallas custom VJPs they port
# ---------------------------------------------------------------------------

S2_SHAPES = [(8, 8, 8, 16), (3, 8, 12, 20)]  # (c, f, h, w) of tests/test_s2_diff.py


@pytest.mark.parametrize("c,f,h,w", S2_SHAPES)
def test_conv_function_matches_pallas_cat_vjp(c, f, h, w):
    """Two parts, bias and ReLU: ``_conv2d_bhcw_cat_bwd``."""
    rng = np.random.default_rng(c + h)
    parts = [rng.standard_normal((2, h, ch, w)).astype(np.float32) for ch in (c, 8)]
    k = (rng.standard_normal((3, 3, c + 8, f)) * 0.2).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    cot = rng.standard_normal((2, h, f, w)).astype(np.float32)
    fn = lambda ps, kk, bb: conv2d_pallas_bhcw_cat(ps, kk, bb, padding=1, relu=True)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(fn, [jnp.asarray(p) for p in parts], jnp.asarray(k), jnp.asarray(b))
        d_parts, d_k, d_b = vjp(jnp.asarray(cot))
    tp = [leaf(bhcw_to_nchw(p)) for p in parts]
    tk, tb = leaf(hwio_to_oihw(k)), leaf(torch.from_numpy(b))
    out = ops.conv3x3_trainable(tp, tk, tb, relu=True)
    out.backward(bhcw_to_nchw(cot))
    assert rel(nchw_to_bhcw(out), want) <= 1e-5
    for t, d in zip(tp, d_parts):
        assert rel(nchw_to_bhcw(t.grad), d) <= 1e-5
    assert rel(tk.grad.numpy(), np.transpose(np.asarray(d_k), (3, 2, 0, 1))) <= 1e-5
    assert rel(tb.grad.numpy(), d_b) <= 1e-5


@pytest.mark.parametrize("c,f,h,w", S2_SHAPES)
def test_stride2_pair_matches_pallas_s2_res_vjp(c, f, h, w):
    """The stacked encoder pair ``[conv3x3_s2 + b | conv1x1_s2]``:
    ``_s2_res_bwd``."""
    rng = np.random.default_rng(10 + c + h)
    x = rng.standard_normal((2, h, c, w)).astype(np.float32)
    km = (rng.standard_normal((3, 3, c, f)) * 0.2).astype(np.float32)
    ks = (rng.standard_normal((1, 1, c, f)) * 0.2).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    cot = rng.standard_normal((2, h // 2, 2 * f, w // 2)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(conv2d_s2_res_pallas_bhcw, *map(jnp.asarray, (x, km, ks, b)))
        d_x, d_km, d_ks, d_b = vjp(jnp.asarray(cot))
    tx, tkm, tks, tb = (leaf(t) for t in (bhcw_to_nchw(x), hwio_to_oihw(km), hwio_to_oihw(ks),
                                          torch.from_numpy(b)))
    out = ops.conv3x3_trainable([tx], *stack_shortcut(tkm, tb, tks), stride=2)
    out.backward(bhcw_to_nchw(cot))
    assert rel(nchw_to_bhcw(out), want) <= 1e-4
    assert rel(nchw_to_bhcw(tx.grad), d_x) <= 1e-4
    assert rel(tkm.grad.numpy(), np.transpose(np.asarray(d_km), (3, 2, 0, 1))) <= 1e-4
    assert rel(tks.grad.numpy(), np.transpose(np.asarray(d_ks), (3, 2, 0, 1))) <= 1e-4
    assert rel(tb.grad.numpy(), d_b) <= 1e-4


@pytest.mark.parametrize("c,f,h,w", S2_SHAPES)
def test_conv_transpose_function_matches_pallas_ct_vjp(c, f, h, w):
    """4x4/s2/p1 transpose conv over two parts of 1 + c channels: ``_ct_bwd``."""
    rng = np.random.default_rng(20 + c + h)
    parts = [rng.standard_normal((2, h // 2, ch, w // 2)).astype(np.float32) for ch in (1, c)]
    k = (rng.standard_normal((4, 4, 1 + c, f)) * 0.2).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    cot = rng.standard_normal((2, h, f, w)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(convtranspose2d_s2_pallas_bhcw, [jnp.asarray(p) for p in parts],
                            jnp.asarray(k), jnp.asarray(b))
        d_parts, d_k, d_b = vjp(jnp.asarray(cot))
    tp = [leaf(bhcw_to_nchw(p)) for p in parts]
    tk, tb = leaf(hwio_to_iohw(k)), leaf(torch.from_numpy(b))
    out = ops.conv_transpose4x4s2_trainable(tp, tk, tb)
    out.backward(bhcw_to_nchw(cot))
    assert rel(nchw_to_bhcw(out), want) <= 1e-4
    for t, d in zip(tp, d_parts):
        assert rel(nchw_to_bhcw(t.grad), d) <= 1e-4
    assert rel(tk.grad.numpy(), np.transpose(np.asarray(d_k), (2, 3, 0, 1))) <= 1e-4
    assert rel(tb.grad.numpy(), d_b) <= 1e-4


def test_functions_skip_the_input_gradient_of_inputs_without_grad():
    """``rgb_encoder0``'s RGB input and each ``depth_conv``'s input need no
    gradient: the Function returns none for them and still gives d_w."""
    x = torch.randn(1, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    out = ops.conv3x3_trainable([x], w, None, relu=True)
    out.sum().backward()
    assert x.grad is None and w.grad is not None


# ---------------------------------------------------------------------------
# The plain versions of the three new gradient forms, against torch in f64
# ---------------------------------------------------------------------------

def _f64(*shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


def test_conv3x3s2_input_grad_plain_matches_torch_grad():
    cot, w = _f64(2, 6, 5, 7, seed=1), _f64(6, 4, 3, 3, seed=2)
    want = torch.nn.grad.conv2d_input((2, 4, 10, 14), w, cot, stride=2, padding=1)
    assert rel(ops.conv3x3s2_input_grad_plain(cot, w), want) <= 1e-12


def test_conv_transpose4x4s2_input_grad_plain_matches_autograd():
    x, w, cot = _f64(2, 5, 4, 6, seed=3).requires_grad_(), _f64(5, 3, 4, 4, seed=4), _f64(2, 3, 8, 12, seed=5)
    F.conv_transpose2d(x, w, stride=2, padding=1).backward(cot)
    assert rel(ops.conv_transpose4x4s2_input_grad_plain(cot, w), x.grad) <= 1e-12


@pytest.mark.parametrize("stride", [1, 2])
def test_wgrad_plain_matches_torch_grad(stride):
    x = [_f64(2, 3, 10, 14, seed=6), _f64(2, 2, 10, 14, seed=7)]  # two parts, 5 channels
    ho, wo = (10 - 1) // stride + 1, (14 - 1) // stride + 1
    g = _f64(2, 6, ho, wo, seed=8)
    want = torch.nn.grad.conv2d_weight(torch.cat(x, 1), (6, 5, 3, 3), g, stride=stride, padding=1)
    assert rel(ops.conv2d_weight_grad_plain(x, [g], 3, 1, stride=stride), want) <= 1e-12


def test_wgrad_plain_gives_the_transpose_conv_weight_grad_with_roles_swapped():
    x = [_f64(2, 1, 4, 6, seed=9), _f64(2, 4, 4, 6, seed=10)]  # the transpose conv's input parts
    w = _f64(5, 3, 4, 4, seed=11).requires_grad_()
    cot = _f64(2, 3, 8, 12, seed=12)
    F.conv_transpose2d(torch.cat(x, 1), w, stride=2, padding=1).backward(cot)
    assert rel(ops.conv2d_weight_grad_plain([cot], x, 4, 1, stride=2), w.grad) <= 1e-12


def test_new_wrappers_take_the_plain_path_on_the_cpu_and_check_geometry():
    kernels.reset_launch_counts()
    g, w3, w4 = torch.randn(1, 4, 3, 5), torch.randn(4, 2, 3, 3), torch.randn(2, 4, 4, 4)
    assert ops.conv3x3s2_input_grad(g, w3).shape == (1, 2, 6, 10)
    assert ops.conv_transpose4x4s2_input_grad(torch.randn(1, 4, 6, 10), w4).shape == (1, 2, 3, 5)
    assert ops.conv2d_wgrad([torch.randn(1, 2, 6, 10)], [g], 3, stride=2, padding=1).shape == (4, 2, 3, 3)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    with pytest.raises(ValueError):  # (3, 5) is not the stride-1 output of (6, 10)
        ops.conv2d_wgrad([torch.randn(1, 2, 6, 10)], [g], 3, stride=1, padding=1)
    x = torch.randn(1, 2, 5, 9, dtype=torch.float64, requires_grad=True)  # odd: the s2 d_x is cropped
    w = w3.double()
    ops.conv3x3_trainable([x], w, None, stride=2).backward(g.double())
    assert rel(x.grad, torch.nn.grad.conv2d_input(x.shape, w, g.double(), stride=2, padding=1)) <= 1e-12


# ---------------------------------------------------------------------------
# The whole GuidedTask
# ---------------------------------------------------------------------------

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


def guided_batch(seed, b, h, w):
    """The JAX bench's synthetic guided batch (smooth truth under a 6% mask,
    uniform RGB), with a per-element phase so batch rows differ."""
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    truth = (2 + np.sin(i / 5)[None] * rng.random((b, 1, 1)) + np.cos(j / 6)[None]).astype(np.float32)[..., None]
    rgb = rng.random((b, h, w, 3)).astype(np.float32)
    return {"rgb": rgb, "depth": truth * (rng.random((b, h, w, 1)) < 0.06).astype(np.float32), "gt": truth}


def _init_variables(h, w, seed):
    z3, z1 = jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w, 1))
    return random_variables(JGuided(), z3, z1, z3, z1, seed=seed)


def _port_model(variables):
    m = GuidedDepthNet(device="cpu")
    m.load_state_dict(from_jax_variables(variables))
    return m


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """JAX ``GuidedTask.loss`` (XLA backend, train=True) at 32x64, B = 2:
    value and gradient of the trainable subtree, as the JAX trainer takes
    them, and the new batch statistics."""
    v = _init_variables(32, 64, seed=3)
    batch = guided_batch(4, 2, 32, 64)
    task, cfg = JGuidedTask(JGuided(backend="xla")), JTrainConfig()
    train_p = {k: p for k, p in v["params"].items() if k != "step1"}

    def loss_fn(tp, bb):
        variables = {"params": {**tp, "step1": v["params"]["step1"]}, "batch_stats": v["batch_stats"]}
        return task.loss(variables, bb, train=True, cfg=cfg)

    (loss, mutated), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        train_p, {k: jnp.asarray(a) for k, a in batch.items()})
    return v, batch, float(loss), grads, mutated["batch_stats"]


def _port_step(variables, batch, dtype):
    """The port's train-mode loss and trainable gradients in ``dtype`` (f64:
    the plain path in float64, the reference for the f32 rounding)."""
    model = GuidedDepthNet(device="cpu", dtype=dtype).to(dtype)
    model.load_state_dict(from_jax_variables(variables))
    loss = GuidedTask(model.train()).loss(
        {k: torch.from_numpy(a).to(dtype) for k, a in batch.items()}, cfg=TrainConfig())
    loss.backward()
    return model, loss.item(), {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def test_guided_task_loss_grads_and_stats_match_jax(jax_loss_and_grads):
    v, batch, want_loss, want_grads, want_stats = jax_loss_and_grads
    model, loss, grads = _port_step(v, batch, torch.float32)
    _, _, grads64 = _port_step(v, batch, torch.float64)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    want = from_jax_variables({"params": want_grads, "batch_stats": want_stats})
    assert len(grads) == sum(1 for k in want if not k.endswith(("running_mean", "running_var")))
    assert not any(n.startswith("step1.") for n in grads)
    for name, g in grads.items():
        bar = max(1e-4, 4 * rel(g.numpy(), grads64[name].numpy()))
        assert rel(g.numpy(), want[name].numpy()) <= bar, name
    for name, buf in model.named_buffers():
        assert rel(buf.numpy(), want[name].numpy()) <= 1e-5, name


def test_guided_task_predicts_the_finest_scale(jax_loss_and_grads):
    v, batch, *_ = jax_loss_and_grads
    model = _port_model(v).eval()
    t = {k: torch.from_numpy(a) for k, a in batch.items()}
    pred = GuidedTask(model).predict(t)
    assert pred.shape == (2, 32, 64, 1) and not pred.requires_grad
    with torch.no_grad():
        assert torch.equal(pred, model(t["rgb"], t["depth"])[0][-1])


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def __call__(self):
        return iter(self.batches)


class _PresetGuidedTask(JGuidedTask):
    """The JAX step-2 task, initialised to a given variable tree."""

    def __init__(self, variables):
        super().__init__(JGuided())
        self.variables = variables

    def init_variables(self, rng, batch):
        return jax.tree.map(jnp.copy, self.variables)  # the trainer donates its state


def _fit_case():
    train = _Batches([guided_batch(40 + i, 2, 16, 32) for i in range(2)])
    val = _Batches([guided_batch(50, 2, 16, 32)])
    kw = dict(epochs=2, batch_size=2, log_every=0)
    opt = dict(name="adamw", learning_rate=1e-4, weight_decay=1e-7)
    return train, val, kw, opt


def _guided_fit(start, train, val, kw, opt, dtype):
    """The port's ``Trainer.fit`` from the state dict ``start``, step 1
    handed over as ``step1_state``; in ``dtype`` (f64: batches and model)."""
    model = GuidedDepthNet(device="cpu", dtype=dtype).to(dtype)
    step1 = {k[len("step1."):]: t for k, t in start.items() if k.startswith("step1.")}
    model.load_state_dict({k: t for k, t in start.items() if not k.startswith("step1.")}, strict=False)
    cast = lambda loader: _Batches([{k: a.astype(dtype == torch.float64 and np.float64 or np.float32)
                                     for k, a in b.items()} for b in loader.batches])
    trainer = Trainer(GuidedTask(model, step1_state=step1), TrainConfig(**kw, optimizer=OptimizerConfig(**opt)),
                      log_fn=lambda m: None, device="cpu")
    return trainer.fit(cast(train), cast(val)), model


def test_trainer_fit_guided_matches_jax_with_step1_frozen():
    train, val, kw, opt = _fit_case()
    v0 = _init_variables(16, 32, seed=6)
    want = JTrainer(_PresetGuidedTask(v0), JTrainConfig(**kw, optimizer=JOptimizerConfig(**opt)),
                    log_fn=lambda m: None).fit(train, val)
    start = from_jax_variables(v0)
    got, model = _guided_fit(start, train, val, kw, opt, torch.float32)
    got64, _ = _guided_fit(start, train, val, kw, opt, torch.float64)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got.history[key], want.history[key], rtol=1e-4)
    want_sd = from_jax_variables(want.best_variables)
    for name, t in got.best_variables.items():
        if name.startswith("step1."):
            assert torch.equal(t, start[name]), name
            assert torch.equal(model.state_dict()[name], start[name]), name
        bar = max(1e-4, 4 * rel(t.numpy(), got64.best_variables[name].numpy()))
        assert rel(t.numpy(), want_sd[name].numpy()) <= bar, name


def _port_fit(tmp_path, epochs, name):
    train, val, kw, opt = _fit_case()
    kw["epochs"] = epochs
    model = GuidedDepthNet(device="cpu", seed=3)
    trainer = Trainer(GuidedTask(model), TrainConfig(**kw, optimizer=OptimizerConfig(**opt)),
                      checkpoints=CheckpointManager(tmp_path / name, keep=2),
                      log_fn=lambda m: None, device="cpu")
    return trainer.fit(train, val), model


def test_guided_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    whole, whole_model = _port_fit(tmp_path, 3, "whole")
    _port_fit(tmp_path, 2, "cut")  # stops after epoch 1, as a killed run would
    resumed, resumed_model = _port_fit(tmp_path, 3, "cut")
    assert resumed.history == whole.history
    whole_sd, resumed_sd = whole_model.state_dict(), resumed_model.state_dict()
    assert any(k.endswith("bn.running_var") for k in whole_sd)
    for n, a in whole_sd.items():
        assert torch.equal(a, resumed_sd[n]), n
    for n, a in whole.best_variables.items():
        assert torch.equal(a, resumed.best_variables[n]), n
