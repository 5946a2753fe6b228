"""Step-1 training of the PyTorch port against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both; weights go through
``convert.from_jax_unguided_variables``. The port runs on CPU tensors, where
the kernel wrappers run their plain versions (the kernels themselves are
held against those on the card by tests/test_torch_kernels.py and
chip_smoke.py). Where the JAX function reaches a Pallas kernel it runs in
interpret mode. Bars: 1e-5 relative RMSE for the gradient ops and the nconv
backward (the frameworks sum in other orders); atol 1e-5 / rtol 1e-4 for the
whole network's gradients (the bar at which the JAX package holds its own
two backends together); 1e-6 for losses, Sobel and optimizer updates; 1e-4
for two epochs of ``Trainer.fit``.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from nconv_tpu import losses as jlosses
from nconv_tpu import ops as jops
from nconv_tpu.cli import _SyntheticDataset as JSyntheticDataset
from nconv_tpu.data.pipeline import Loader as JLoader
from nconv_tpu.models import NConvUNet as JUNet
from nconv_tpu.ops.pallas_conv import conv_filtergrad_pallas_bhcw, transpose_conv_bhcw
from nconv_tpu.ops.pallas_nconv_mxu import nconv2d_pallas_mxu_bhcw
from nconv_tpu.ops.pool import max_pool2d as jmax_pool2d
from nconv_tpu.ops.sobel import edge_magnitude as jedge_magnitude
from nconv_tpu.ops.sobel import sobel_xy as jsobel_xy
from nconv_tpu.training import optim as joptim
from nconv_tpu.training import OptimizerConfig as JOptimizerConfig
from nconv_tpu.training import TrainConfig as JTrainConfig
from nconv_tpu.training import Trainer as JTrainer
from nconv_tpu.training import UnguidedTask as JUnguidedTask
from nconv_tpu_torch import losses, ops
from nconv_tpu_torch.convert import from_jax_unguided_variables
from nconv_tpu_torch.data import Loader, SyntheticDataset, prefetch_to_device
from nconv_tpu_torch.models import NConvUNet
from nconv_tpu_torch.ops.sobel import edge_magnitude, sobel_xy
from nconv_tpu_torch.training import (
    CheckpointManager,
    OptimizerConfig,
    TrainConfig,
    Trainer,
    UnguidedTask,
    build_optimizer,
    build_scheduler,
    get_learning_rate,
    set_learning_rate,
)
from nconv_tpu_torch.training.config import SchedulerConfig
from nconv_tpu_torch.utils import save_depth


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def bhcw_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 2, 1, 3))))


def nchw_to_bhcw(t):
    return np.transpose(t.detach().numpy(), (0, 2, 1, 3))


def hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))


def oihw_to_hwio(t):
    return np.transpose(t.detach().numpy(), (2, 3, 1, 0))


# ---------------------------------------------------------------------------
# The two gradient ops against the Pallas kernels they port
# ---------------------------------------------------------------------------

# (k, padding, cin, cout): nconv2's 5x5 p2, nconv6's 3x3 p0, nconv7's 1x1 p2
# (input-grad crop 2, filter-grad pad_bottom 2), nconv1's 5x5 p2 from one
# channel
GEOMETRIES = [(5, 2, 8, 8), (3, 0, 16, 8), (1, 2, 8, 1), (5, 2, 1, 8)]


@pytest.mark.parametrize("k,p,cin,cout", GEOMETRIES)
def test_input_grad_matches_pallas_transpose_conv(k, p, cin, cout):
    rng = np.random.default_rng(k)
    h, w = 8, 24
    ho, wo = h + 2 * p - k + 1, w + 2 * p - k + 1
    cot = rng.standard_normal((2, ho, cout, wo)).astype(np.float32)
    wk = rng.random((k, k, cin, cout)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = transpose_conv_bhcw(jnp.asarray(cot), jnp.asarray(wk), p)
    got = ops.conv2d_input_grad(bhcw_to_nchw(cot), hwio_to_oihw(wk), p)
    assert got.shape == (2, cin, h, w)
    assert rel(nchw_to_bhcw(got), want) <= 1e-5


@pytest.mark.parametrize("k,p,cin,cout", GEOMETRIES)
def test_weight_grad_matches_pallas_filtergrad(k, p, cin, cout):
    rng = np.random.default_rng(10 + k)
    h, w = 8, 24
    ho, wo = h + 2 * p - k + 1, w + 2 * p - k + 1
    x = rng.standard_normal((2, h, cin, w)).astype(np.float32)
    g = rng.standard_normal((2, ho, cout, wo)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = conv_filtergrad_pallas_bhcw(jnp.asarray(x), jnp.asarray(g), kh=k, kw=k, padding=p)
    got = ops.conv2d_weight_grad(bhcw_to_nchw(x), bhcw_to_nchw(g), k, p)
    assert got.shape == (cout, cin, k, k)
    assert rel(oihw_to_hwio(got), want) <= 1e-5


def test_weight_grad_takes_an_asymmetric_row_window():
    """pad_top apart from padding: the bottom pad follows from the output
    height (here 0, as in the JAX package's stride-2 row-pair form)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = conv_filtergrad_pallas_bhcw(jnp.asarray(x), jnp.asarray(g), kh=3, kw=3, padding=1, pad_top=1)
    got = ops.conv2d_weight_grad(bhcw_to_nchw(x), bhcw_to_nchw(g), 3, 1, pad_top=1)
    assert rel(oihw_to_hwio(got), want) <= 1e-5
    with pytest.raises(ValueError):  # a negative implied bottom pad
        ops.conv2d_weight_grad(bhcw_to_nchw(x), bhcw_to_nchw(g), 3, 1, pad_top=3)


# ---------------------------------------------------------------------------
# The normalized-conv Function
# ---------------------------------------------------------------------------

def _nconv_case(seed, b=2, h=8, w=24, cin=8, cout=8, k=5):
    rng = np.random.default_rng(seed)
    d = (rng.random((b, h, w, cin)) * 10).astype(np.float32)
    c = (rng.random((b, h, w, cin)) > 0.3).astype(np.float32)
    kern = (rng.standard_normal((k, k, cin, cout)) * 0.5).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    g_out = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    g_conf = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return d, c, kern, bias, g_out, g_conf


def _port_nconv_grads(d, c, kern, bias, g_out, g_conf, pos_fn, padding):
    """The port's Function on NHWC numpy inputs; returns NHWC/HWIO grads."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))).requires_grad_()
    dt, ct = t(d), t(c)
    kt = hwio_to_oihw(kern).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    out, conf = ops.nconv2d_trainable(dt, ct, ops.POS_FNS[pos_fn](kt), bt, padding=padding)
    torch.autograd.backward((out, conf), (t(g_out).detach(), t(g_conf).detach()))
    nhwc = lambda x: np.transpose(x.numpy(), (0, 2, 3, 1))
    return nhwc(dt.grad), nhwc(ct.grad), oihw_to_hwio(kt.grad), bt.grad.numpy()


def test_nconv_function_matches_pallas_vjp():
    d, c, kern, bias, g_out, g_conf = _nconv_case(0)
    b4 = lambda a: jnp.asarray(np.transpose(a, (0, 1, 3, 2)))  # NHWC -> BHCW
    f = lambda dd, cc, kk, bb: nconv2d_pallas_mxu_bhcw(dd, cc, kk, bb, padding=2, pos_fn="softplus")
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, b4(d), b4(c), jnp.asarray(kern), jnp.asarray(bias))
        want = vjp((b4(g_out), b4(g_conf)))
    nhwc = lambda a: np.transpose(np.asarray(a), (0, 1, 3, 2))
    want = [nhwc(want[0]), nhwc(want[1]), want[2], want[3]]
    for got, exp in zip(_port_nconv_grads(d, c, kern, bias, g_out, g_conf, "softplus", 2), want):
        assert rel(got, exp) <= 1e-5


@pytest.mark.parametrize("pos_fn", ["softplus", "exp", "sigmoid", "softmax", "identity"])
def test_nconv_function_matches_jax_autodiff(pos_fn):
    d, c, kern, bias, g_out, g_conf = _nconv_case(1, k=3, cin=4)
    if pos_fn == "identity":
        kern = np.abs(kern)
    f = lambda dd, cc, kk, bb: jops.nconv2d(dd, cc, kk, bb, padding=1, pos_fn=pos_fn)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (d, c, kern, bias)))
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_conf)))
    for got, exp in zip(_port_nconv_grads(d, c, kern, bias, g_out, g_conf, pos_fn, 1), want):
        assert rel(got, exp) <= 1e-5


def test_nconv_layer_takes_single_tensors_with_grad():
    layer = NConvUNet(device="cpu").nconv4
    x = torch.rand(1, 8, 8, 8)
    with pytest.raises(ValueError):
        layer([x, x[..., ::2, ::2]], [x, x[..., ::2, ::2]], up2=[False, True])


def test_pool_splits_tie_gradients_as_jax():
    """Confidence is exactly 0 far from any sample, so pool windows tie; the
    JAX training graph's split maxes halve the cotangent at each level."""
    rng = np.random.default_rng(4)
    x = (rng.random((2, 8, 3, 10)) * (rng.random((2, 8, 3, 10)) < 0.2)).astype(np.float32)  # BHCW
    x[0, 0:2, 0, 0:2] = 0.5  # a non-zero tie
    g = rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
    y, vjp = jax.vjp(lambda a: jmax_pool2d(a, layout="bhcw"), jnp.asarray(x))
    want = vjp(jnp.asarray(g))[0]
    xt = bhcw_to_nchw(x).requires_grad_()
    yt = ops.max_pool2x2(xt)
    yt.backward(bhcw_to_nchw(g))
    np.testing.assert_array_equal(nchw_to_bhcw(yt), np.asarray(y))
    np.testing.assert_array_equal(nchw_to_bhcw(xt.grad), np.asarray(want))
    np.testing.assert_array_equal(xt.grad[0, 0, 0:2, 0:2].numpy(), np.full((2, 2), g[0, 0, 0, 0] / 4))


# ---------------------------------------------------------------------------
# The whole step-1 network
# ---------------------------------------------------------------------------

def _dense_batch(seed, b, h, w, density):
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    truth = (2 + np.sin(i / 5)[None] * rng.random((b, 1, 1)) + np.cos(j / 6)[None]).astype(np.float32)[..., None]
    return {"depth": truth * (rng.random((b, h, w, 1)) < density).astype(np.float32), "gt": truth}


UNET_LAYERS = [("nconv1", 5, 1, 8), ("nconv2", 5, 8, 8), ("nconv_down1", 5, 8, 8),
               ("nconv_down2", 5, 8, 8), ("nconv_down3", 5, 8, 8), ("nconv4", 3, 16, 8),
               ("nconv5", 3, 16, 8), ("nconv6", 3, 16, 8), ("nconv7", 1, 8, 1)]


def unet_variables(seed):
    """A JAX ``NConvUNet`` variable tree from numpy: raw kernels U[0, 1)
    (before softplus), biases 0.01 as the init sets them. Built by hand,
    since tracing the flax init takes seconds on the CPU."""
    rng = np.random.default_rng(seed)
    return {"params": {
        name: {"kernel": jnp.asarray(rng.random((k, k, cin, cout)).astype(np.float32)),
               "bias": jnp.full((cout,), 0.01, jnp.float32)}
        for name, k, cin, cout in UNET_LAYERS}}


class _PresetTask(JUnguidedTask):
    """The JAX step-1 task, initialised to a given variable tree."""

    def __init__(self, variables):
        super().__init__(JUNet())
        self.variables = variables

    def init_variables(self, rng, batch):
        return jax.tree.map(jnp.copy, self.variables)  # the trainer donates its state


def test_unet_loss_and_grads_match_jax():
    batch = _dense_batch(5, 1, 24, 32, 0.2)
    jtask = JUnguidedTask(JUNet(backend="xla"))
    v = unet_variables(0)
    jcfg = JTrainConfig()
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        lambda vv, bb: jtask.loss(vv, bb, train=True, cfg=jcfg), has_aux=True))(
        v, {k: jnp.asarray(a) for k, a in batch.items()})
    model = NConvUNet(device="cpu")
    model.load_state_dict(from_jax_unguided_variables(v))
    loss = UnguidedTask(model).loss({k: torch.from_numpy(a) for k, a in batch.items()}, cfg=TrainConfig())
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-6)
    want_sd = from_jax_unguided_variables(want)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# Losses and Sobel
# ---------------------------------------------------------------------------

def _value_and_grad_both(jfn, tfn, *arrays):
    """Value and gradient w.r.t. the first array, JAX and port."""
    want, jgrad = jax.jit(jax.value_and_grad(jfn))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a) for a in arrays]
    ts[0].requires_grad_()
    got = tfn(*ts)
    got.backward()
    return (got.item(), ts[0].grad.numpy()), (float(want), np.asarray(jgrad))


LOSS_CASES = {
    "masked_mse": (jlosses.masked_mse, losses.masked_mse),
    "gradient_loss": (jlosses.gradient_loss, losses.gradient_loss),
    "depth_loss": (jlosses.depth_loss, losses.depth_loss),
    "depth_loss_mse_only": (lambda p, g: jlosses.depth_loss(p, g, use_gradient_loss=False),
                            lambda p, g: losses.depth_loss(p, g, use_gradient_loss=False)),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(6)
    pred = rng.standard_normal((2, 12, 20, 1)).astype(np.float32) + 3
    gt = (rng.random((2, 12, 20, 1)) * 5 * (rng.random((2, 12, 20, 1)) < 0.5)).astype(np.float32)
    (v, g), (wv, wg) = _value_and_grad_both(*LOSS_CASES[name], pred, gt)
    assert v == pytest.approx(wv, rel=1e-6)
    assert rel(g, wg) <= 1e-6


@pytest.mark.parametrize("batch_reduce", ["mean", "first"])
def test_multi_resolution_loss_matches_jax(batch_reduce):
    rng = np.random.default_rng(7)
    gt = (rng.random((2, 16, 24, 1)) * 5 * (rng.random((2, 16, 24, 1)) < 0.6)).astype(np.float32)
    scales = [rng.standard_normal((2, 16 // f, 24 // f, 1)).astype(np.float32) + 2 for f in (4, 2, 1)]
    jfn = lambda s0, s1, s2, g: jlosses.multi_resolution_loss([s0, s1, s2], g, batch_reduce=batch_reduce)
    tfn = lambda s0, s1, s2, g: losses.multi_resolution_loss([s0, s1, s2], g, batch_reduce=batch_reduce)
    (v, g0), (wv, wg0) = _value_and_grad_both(jfn, tfn, *scales, gt)
    assert v == pytest.approx(wv, rel=1e-6)
    assert rel(g0, wg0) <= 1e-6


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("convention", ["loss", "edge"])
def test_sobel_matches_jax(channels, convention):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 10, 14, channels)).astype(np.float32)
    cx, cy = (rng.standard_normal(x.shape).astype(np.float32) for _ in range(2))
    want, vjp = jax.vjp(lambda a: jsobel_xy(a, convention=convention), jnp.asarray(x))
    want_grad = vjp((jnp.asarray(cx), jnp.asarray(cy)))[0]
    xt = torch.from_numpy(x).requires_grad_()
    got = sobel_xy(xt, convention=convention)
    torch.autograd.backward(got, (torch.from_numpy(cx), torch.from_numpy(cy)))
    for g, w in zip(got, want):
        assert rel(g.detach().numpy(), w) <= 1e-6
    assert rel(xt.grad.numpy(), want_grad) <= 1e-6
    assert rel(edge_magnitude(torch.from_numpy(x)).numpy(), jedge_magnitude(jnp.asarray(x))) <= 1e-6


# ---------------------------------------------------------------------------
# Optimizers and schedulers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "sgd", "rmsprop"])
def test_optimizers_match_optax(name):
    """Three steps on the same gradients, the LR changed before the third."""
    rng = np.random.default_rng(9)
    shapes = [(4, 3), (5,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    kw = dict(name=name, learning_rate=1e-2, weight_decay=1e-2, momentum=0.9)
    tx = joptim.build_optimizer(JOptimizerConfig(**kw))
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = build_optimizer(OptimizerConfig(**kw), params)
    for step, gs in enumerate(grads):
        if step == 2:
            state = joptim.set_learning_rate(state, 3e-3)
            set_learning_rate(opt, 3e-3)
            assert get_learning_rate(opt) == pytest.approx(joptim.get_learning_rate(state))
        upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    for p, w in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["plateau", "linear", "constant"])
def test_schedulers_match_jax(kind):
    cfg = SchedulerConfig(kind=kind, factor=0.5, patience=1)
    ours = build_scheduler(cfg, 0.1, 6)
    theirs = joptim.build_scheduler(cfg, 0.1, 6)
    for v in [3.0, 2.0, 2.0, 2.0, 2.5, 1.0, 1.0, 1.0]:  # ties do not improve (strict <)
        assert ours.step(v) == theirs.step(v)
        assert ours.state_dict() == theirs.state_dict()
    fresh = build_scheduler(cfg, 0.1, 6)
    fresh.load_state_dict(ours.state_dict())
    assert fresh.step(0.5) == ours.step(0.5)


# ---------------------------------------------------------------------------
# Trainer, checkpoints, data
# ---------------------------------------------------------------------------

class _Batches:
    """A fixed list of numpy batches, re-iterable (a loader callable)."""

    def __init__(self, batches):
        self.batches = batches

    def __call__(self):
        return iter(self.batches)


def _fit_case():
    train = _Batches([_dense_batch(20 + i, 2, 16, 32, 0.3) for i in range(2)])
    val = _Batches([_dense_batch(30, 2, 16, 32, 0.3)])
    kw = dict(epochs=2, batch_size=2, log_every=0)
    opt = dict(name="adamw", learning_rate=1e-2, weight_decay=1e-7)
    return train, val, kw, opt


def test_trainer_fit_matches_jax():
    train, val, kw, opt = _fit_case()
    v0 = unet_variables(1)
    jtrainer = JTrainer(_PresetTask(v0), JTrainConfig(**kw, optimizer=JOptimizerConfig(**opt)),
                        log_fn=lambda m: None)
    want = jtrainer.fit(train, val)
    model = NConvUNet(device="cpu")
    model.load_state_dict(from_jax_unguided_variables(v0))
    trainer = Trainer(UnguidedTask(model), TrainConfig(**kw, optimizer=OptimizerConfig(**opt)),
                      log_fn=lambda m: None, device="cpu")
    got = trainer.fit(train, val)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got.history[key], want.history[key], rtol=1e-4)
    assert got.history["lr"] == pytest.approx(want.history["lr"])
    want_sd = from_jax_unguided_variables(want.best_variables)
    for name, p in got.best_variables.items():
        assert rel(p.numpy(), want_sd[name].numpy()) <= 1e-4, name


def _port_fit(tmp_path, epochs, name, resume=True):
    train, val, kw, opt = _fit_case()
    kw["epochs"] = epochs
    model = NConvUNet(device="cpu", seed=3)
    trainer = Trainer(UnguidedTask(model), TrainConfig(**kw, optimizer=OptimizerConfig(**opt)),
                      checkpoints=CheckpointManager(tmp_path / name, keep=2),
                      log_fn=lambda m: None, device="cpu")
    return trainer.fit(train, val, resume=resume), model


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    whole, whole_model = _port_fit(tmp_path, 3, "whole")
    _port_fit(tmp_path, 2, "cut")  # stops after epoch 1, as a killed run would
    resumed, resumed_model = _port_fit(tmp_path, 3, "cut")
    assert resumed.history == whole.history
    assert resumed.best_val_loss == whole.best_val_loss
    for (n, a), (_, b) in zip(whole_model.state_dict().items(), resumed_model.state_dict().items()):
        assert torch.equal(a, b), n
    for n, a in whole.best_variables.items():
        assert torch.equal(a, resumed.best_variables[n]), n
    ckpts = CheckpointManager(tmp_path / "cut")
    assert ckpts.latest_epoch() == 2
    assert sorted(p.name for p in (tmp_path / "cut").iterdir()) == [
        "best_variables.pt", "epoch_000001.pt", "epoch_000002.pt"]  # keep=2


def test_trainer_raises_on_a_non_finite_loss(tmp_path):
    bad = _dense_batch(0, 2, 16, 32, 0.3)
    bad["gt"][0, 0, 0, 0] = np.nan
    trainer = Trainer(UnguidedTask(NConvUNet(device="cpu")), TrainConfig(epochs=1, log_every=0),
                      log_fn=lambda m: None, device="cpu")
    with pytest.raises(FloatingPointError):
        trainer.fit(_Batches([bad]), _Batches([bad]))


def test_trainer_stops_early_after_patience_and_extra_bad_epochs():
    """With lr 0 the val loss never improves after epoch 0, so the run stops
    once patience + early_stop_extra epochs in a row were bad."""
    train, val, kw, _ = _fit_case()
    kw.update(epochs=10, early_stopping=True, early_stop_extra=1,
              scheduler=SchedulerConfig(patience=1))
    got = Trainer(UnguidedTask(NConvUNet(device="cpu")),
                  TrainConfig(**kw, optimizer=OptimizerConfig("adamw", 0.0)),
                  log_fn=lambda m: None, device="cpu").fit(train, val)
    assert len(got.history["val_loss"]) == 3


def test_trainer_dumps_depth_images(tmp_path, monkeypatch):
    """The dumps are inferno PNGs, pixel-equal to the JAX package's
    ``utils.save_depth`` (the JAX trainer's dump) of the same arrays."""
    from PIL import Image

    from nconv_tpu.utils import save_depth as jsave_depth
    from nconv_tpu_torch.training import trainer as trainer_module

    dumped = []
    real = trainer_module.save_depth
    monkeypatch.setattr(trainer_module, "save_depth",
                        lambda d, path: (dumped.append((d, path)), real(d, path)))
    train, val, kw, opt = _fit_case()
    kw.update(epochs=1, dump_images_every=1, image_dir=str(tmp_path / "port"), run_name="r")
    Trainer(UnguidedTask(NConvUNet(device="cpu")), TrainConfig(**kw), log_fn=lambda m: None,
            device="cpu").fit(train, val)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(f"r_e0_b{i}_{s}.png" for i in (0, 1) for s in ("out", "sparse", "gt"))
    assert sorted(os.path.basename(p) for _, p in dumped) == names
    for d, path in dumped:
        want = str(tmp_path / os.path.basename(path))
        jsave_depth(d, want)
        img = np.asarray(Image.open(path))
        assert img.shape == (16, 32, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, np.asarray(Image.open(want)))


def test_trainer_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(UnguidedTask(NConvUNet(device="cpu")), TrainConfig())


def test_synthetic_data_and_loader_match_jax():
    ours, theirs = SyntheticDataset(6, 16, 24, seed=2), JSyntheticDataset(6, 16, 24, seed=2)
    for a, b in zip(Loader(ours, 4, shuffle=True, seed=1, num_workers=2),
                    JLoader(theirs, 4, shuffle=True, seed=1)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    staged = list(prefetch_to_device(Loader(ours, 4), "cpu"))
    assert [tuple(b["depth"].shape) for b in staged] == [(4, 16, 24, 1), (2, 16, 24, 1)]
    assert all(isinstance(t, torch.Tensor) for b in staged for t in b.values())


def test_save_depth_writes_a_readable_inferno_png(tmp_path):
    from PIL import Image

    from nconv_tpu_torch.utils.colormap import INFERNO

    d = np.linspace(0, 1, 12, dtype=np.float32).reshape(1, 3, 4, 1)
    save_depth(d, str(tmp_path / "d.png"))
    img = np.asarray(Image.open(tmp_path / "d.png"))
    assert img.shape == (3, 4, 3)
    np.testing.assert_array_equal(img[0, 0], INFERNO[0])
    np.testing.assert_array_equal(img[-1, -1], INFERNO[255])
