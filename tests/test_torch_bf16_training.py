"""Guided training of the PyTorch port in the mixed schedule (bf16 feature
convs, f32 step 1, depth tensors, loss, BN statistics and master weights)
against the JAX package's bf16 recipe, and the port's metrics and
evaluation, on the CPU.

Inputs come from numpy seeds and go to both; weights go through
``convert.from_jax_variables``. The port runs on CPU tensors, where the
kernel wrappers run their plain versions, which round where the kernels do
(tests/test_torch_kernels.py holds the kernels' bf16 forms to them on the
card). Where the JAX function reaches a Pallas kernel it runs in interpret
mode.

bf16 rounds at other places in the two frameworks (an XLA bf16 conv against
an f32 sum rounded once, a bf16 sum of a cotangent, a ReLU mask on a bf16
output that flips), so the port is held to JAX's bf16 recipe by how far
each stands from the exact result:
  * the conv Functions: rel RMSE <= 4e-3 (about one bf16 ulp) against
    JAX's bf16 custom VJP; where an output misses that, port and JAX are
    both held against the f64 result of the same bf16 operands, and the
    port may stand at most 2x as far from it as JAX;
  * the whole ``GuidedTask``: the loss within 1e-4 of JAX bf16's, and each
    gradient within max(1e-3, 2x JAX bf16's own distance) of JAX f32;
  * two epochs of ``Trainer.fit``: the losses and the best variables within
    max(1e-3, 2x JAX bf16's own distance) of JAX f32's fit.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nconv_tpu import metrics as jmetrics
from nconv_tpu.models import GuidedDepthNet as JGuided
from nconv_tpu.models import NConvUNet as JNConvUNet
from nconv_tpu.ops.pallas_conv import conv2d_pallas_bhcw_cat
from nconv_tpu.ops.pallas_s2 import conv2d_s2_res_pallas_bhcw, convtranspose2d_s2_pallas_bhcw
from nconv_tpu.training import GuidedTask as JGuidedTask
from nconv_tpu.training import OptimizerConfig as JOptimizerConfig
from nconv_tpu.training import TrainConfig as JTrainConfig
from nconv_tpu.training import Trainer as JTrainer
from nconv_tpu.training import evaluate as jevaluate
from nconv_tpu.training import make_guided_predict as jmake_guided_predict
from nconv_tpu.training import make_unguided_predict as jmake_unguided_predict
from nconv_tpu_torch import metrics, ops
from nconv_tpu_torch.convert import from_jax_variables
from nconv_tpu_torch.models import GuidedDepthNet, NConvUNet
from nconv_tpu_torch.models.layers import stack_shortcut
from nconv_tpu_torch.training import (
    GuidedTask,
    OptimizerConfig,
    TrainConfig,
    Trainer,
    evaluate,
    make_guided_predict,
    make_unguided_predict,
)
from test_torch_guided_training import (
    _Batches,
    _fit_case,
    _init_variables,
    bhcw_to_nchw,
    guided_batch,
    hwio_to_iohw,
    hwio_to_oihw,
    leaf,
    nchw_to_bhcw,
    rel,
)

BF16 = torch.bfloat16
JBF16 = dict(backend="xla", dtype=jnp.bfloat16, step1_dtype=jnp.float32)  # the JAX recipe's model


def _bf16(a):
    """numpy f32 -> the nearest bf16 values, as f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _hold(got, want, exact, name):
    """``got`` (port) within 4e-3 of ``want`` (JAX), or no more than 2x as
    far as JAX from ``exact`` (f64 of the same bf16 operands)."""
    if rel(got, want) <= 4e-3:
        return
    assert rel(got, exact) <= 2 * rel(want, exact), (name, rel(got, want), rel(got, exact), rel(want, exact))


# ---------------------------------------------------------------------------
# (a) the three conv Functions in bf16 against the Pallas custom VJPs
# ---------------------------------------------------------------------------

def _jax_bf16_vjp(fn, args, cot):
    """``jax.vjp`` of ``fn`` on bf16 operands (the Pallas kernels in interpret
    mode); outputs and cotangents as f32 numpy."""
    to_bf16 = lambda a: jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), a)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fn, *to_bf16(args))
        grads = vjp(jnp.asarray(cot, jnp.bfloat16))
    f32 = lambda x: np.asarray(x.astype(jnp.float32))
    return f32(out), jax.tree.map(f32, grads)


def _port_bf16(fn, leaves, cot):
    """The port's Function ``fn(*leaves)`` on bf16 leaves; output and the
    leaves' gradients, each in its leaf's dtype."""
    out = fn(*leaves)
    out.backward(cot)
    return out, [t.grad for t in leaves]


def _exact(fn, leaves, cot):
    """The same function on the same values in f64, by torch autograd."""
    leaves64 = [t.detach().double().requires_grad_() for t in leaves]
    out = fn(*leaves64)
    out.backward(cot.double())
    return out, [t.grad for t in leaves64]


def test_bf16_conv_function_matches_pallas_cat_vjp():
    """Two parts, bias and ReLU: ``_conv2d_bhcw_cat_bwd`` on bf16 operands."""
    c, f, h, w = 8, 8, 8, 16
    rng = np.random.default_rng(30)
    parts = [_bf16(rng.standard_normal((2, h, ch, w))) for ch in (c, 8)]
    k = _bf16(rng.standard_normal((3, 3, c + 8, f)) * 0.2)
    b = _bf16(rng.standard_normal(f))
    cot = _bf16(rng.standard_normal((2, h, f, w)))
    want, (d_parts, d_k, d_b) = _jax_bf16_vjp(
        lambda ps, kk, bb: conv2d_pallas_bhcw_cat(ps, kk, bb, padding=1, relu=True), (parts, k, b), cot)
    leaves = [leaf(bhcw_to_nchw(p).to(BF16)) for p in parts] + [leaf(hwio_to_oihw(k).to(BF16)),
                                                                leaf(torch.from_numpy(b).to(BF16))]
    port = lambda p0, p1, kk, bb: ops.conv3x3_trainable([p0, p1], kk, bb, relu=True)
    plain = lambda p0, p1, kk, bb: torch.relu(F.conv2d(torch.cat([p0, p1], 1), kk, bb, padding=1))
    out, grads = _port_bf16(port, leaves, bhcw_to_nchw(cot).to(BF16))
    exact, egrads = _exact(plain, leaves, bhcw_to_nchw(cot))
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    to_bhcw = lambda t: nchw_to_bhcw(t.float())
    to_hwio = lambda t: np.transpose(t.detach().float().numpy(), (2, 3, 1, 0))
    _hold(to_bhcw(out), want, to_bhcw(exact), "out")
    for i in range(2):
        _hold(to_bhcw(grads[i]), d_parts[i], to_bhcw(egrads[i]), f"d_part{i}")
    _hold(to_hwio(grads[2]), d_k, to_hwio(egrads[2]), "d_k")
    _hold(grads[3].float().numpy(), d_b, egrads[3].numpy(), "d_b")


def test_bf16_stride2_pair_matches_pallas_s2_res_vjp():
    """The stacked encoder pair ``[conv3x3_s2 + b | conv1x1_s2]``:
    ``_s2_res_bwd`` on bf16 operands."""
    c, f, h, w = 8, 8, 8, 16
    rng = np.random.default_rng(31)
    x = _bf16(rng.standard_normal((2, h, c, w)))
    km = _bf16(rng.standard_normal((3, 3, c, f)) * 0.2)
    ks = _bf16(rng.standard_normal((1, 1, c, f)) * 0.2)
    b = _bf16(rng.standard_normal(f))
    cot = _bf16(rng.standard_normal((2, h // 2, 2 * f, w // 2)))
    want, (d_x, d_km, d_ks, d_b) = _jax_bf16_vjp(conv2d_s2_res_pallas_bhcw, (x, km, ks, b), cot)
    leaves = [leaf(t.to(BF16)) for t in (bhcw_to_nchw(x), hwio_to_oihw(km), hwio_to_oihw(ks), torch.from_numpy(b))]
    port = lambda xx, m, s, bb: ops.conv3x3_trainable([xx], *stack_shortcut(m, bb, s), stride=2)
    plain = lambda xx, m, s, bb: torch.cat([F.conv2d(xx, m, bb, stride=2, padding=1), F.conv2d(xx, s, stride=2)], 1)
    out, grads = _port_bf16(port, leaves, bhcw_to_nchw(cot).to(BF16))
    exact, egrads = _exact(plain, leaves, bhcw_to_nchw(cot))
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    to_bhcw = lambda t: nchw_to_bhcw(t.float())
    to_hwio = lambda t: np.transpose(t.detach().float().numpy(), (2, 3, 1, 0))
    _hold(to_bhcw(out), want, to_bhcw(exact), "out")
    _hold(to_bhcw(grads[0]), d_x, to_bhcw(egrads[0]), "d_x")
    _hold(to_hwio(grads[1]), d_km, to_hwio(egrads[1]), "d_km")
    _hold(to_hwio(grads[2]), d_ks, to_hwio(egrads[2]), "d_ks")
    _hold(grads[3].float().numpy(), d_b, egrads[3].numpy(), "d_b")


def test_bf16_conv_transpose_function_matches_pallas_ct_vjp():
    """4x4/s2/p1 transpose conv over two parts of 1 + c channels: ``_ct_bwd``
    on bf16 operands."""
    c, f, h, w = 8, 8, 8, 16
    rng = np.random.default_rng(32)
    parts = [_bf16(rng.standard_normal((2, h // 2, ch, w // 2))) for ch in (1, c)]
    k = _bf16(rng.standard_normal((4, 4, 1 + c, f)) * 0.2)
    b = _bf16(rng.standard_normal(f))
    cot = _bf16(rng.standard_normal((2, h, f, w)))
    want, (d_parts, d_k, d_b) = _jax_bf16_vjp(convtranspose2d_s2_pallas_bhcw, (parts, k, b), cot)
    leaves = [leaf(bhcw_to_nchw(p).to(BF16)) for p in parts] + [leaf(hwio_to_iohw(k).to(BF16)),
                                                                leaf(torch.from_numpy(b).to(BF16))]
    port = lambda p0, p1, kk, bb: ops.conv_transpose4x4s2_trainable([p0, p1], kk, bb)
    plain = lambda p0, p1, kk, bb: F.conv_transpose2d(torch.cat([p0, p1], 1), kk, bb, stride=2, padding=1)
    out, grads = _port_bf16(port, leaves, bhcw_to_nchw(cot).to(BF16))
    exact, egrads = _exact(plain, leaves, bhcw_to_nchw(cot))
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    to_bhcw = lambda t: nchw_to_bhcw(t.float())
    to_hwio = lambda t: np.transpose(t.detach().float().numpy(), (2, 3, 0, 1))
    _hold(to_bhcw(out), want, to_bhcw(exact), "out")
    for i in range(2):
        _hold(to_bhcw(grads[i]), d_parts[i], to_bhcw(egrads[i]), f"d_part{i}")
    _hold(to_hwio(grads[2]), d_k, to_hwio(egrads[2]), "d_k")
    _hold(grads[3].float().numpy(), d_b, egrads[3].numpy(), "d_b")


# ---------------------------------------------------------------------------
# (b) the whole GuidedTask in bf16 against JAX's bf16 recipe
# ---------------------------------------------------------------------------

def _jax_loss_and_grads(v, batch, **model_kw):
    task, cfg = JGuidedTask(JGuided(**model_kw)), JTrainConfig()
    train_p = {k: p for k, p in v["params"].items() if k != "step1"}

    def loss_fn(tp, bb):
        variables = {"params": {**tp, "step1": v["params"]["step1"]}, "batch_stats": v["batch_stats"]}
        return task.loss(variables, bb, train=True, cfg=cfg)

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        train_p, {k: jnp.asarray(a) for k, a in batch.items()})
    return float(loss), from_jax_variables({"params": grads})


def test_bf16_guided_task_loss_and_grads_match_jax_bf16():
    """32x64, B = 2: the loss within 1e-4 of JAX bf16's; each gradient no
    further from JAX f32 than max(1e-3, 2x JAX bf16's own distance)."""
    v = _init_variables(32, 64, seed=3)
    batch = guided_batch(4, 2, 32, 64)
    loss32, want32 = _jax_loss_and_grads(v, batch, backend="xla")
    loss16, want16 = _jax_loss_and_grads(v, batch, **JBF16)
    model = GuidedDepthNet(device="cpu", dtype=BF16)
    model.load_state_dict(from_jax_variables(v))
    loss = GuidedTask(model.train()).loss({k: torch.from_numpy(a) for k, a in batch.items()}, cfg=TrainConfig())
    loss.backward()
    assert loss.dtype == torch.float32
    assert loss.item() == pytest.approx(loss16, rel=1e-4)
    assert loss16 != loss32  # the recipe does round
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert set(grads) == set(want32)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        bar = max(1e-3, 2 * rel(want16[name].numpy(), want32[name].numpy()))
        assert rel(g.numpy(), want32[name].numpy()) <= bar, name


# ---------------------------------------------------------------------------
# (c) f32 master weights
# ---------------------------------------------------------------------------

def test_bf16_model_keeps_f32_masters_and_casts_a_copy_per_call():
    """The unfolded bf16 model holds the loaded state bit for bit; after an
    optimizer step its forward reads the stepped masters, rounded on the
    call: it equals a fresh bf16 model loaded with them."""
    v = _init_variables(16, 32, seed=5)
    state = from_jax_variables(v)
    model = GuidedDepthNet(device="cpu", dtype=BF16)
    model.load_state_dict(state)
    for name, t in model.state_dict().items():
        assert t.dtype == state[name].dtype and torch.equal(t, state[name]), name
    batch = {k: torch.from_numpy(a) for k, a in guided_batch(8, 1, 16, 32).items()}
    model.step1.requires_grad_(False)
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=1e-3, weight_decay=1e-7)
    GuidedTask(model.train()).loss(batch, cfg=TrainConfig()).backward()
    opt.step()
    fresh = GuidedDepthNet(device="cpu", dtype=BF16)
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model.eval()(batch["rgb"], batch["depth"])[0]
        want = fresh.eval()(batch["rgb"], batch["depth"])[0]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a stepped weight is not a bf16 value, and the forward rounds it
    w = model.fuse3.conv.conv.weight
    assert w.dtype == torch.float32 and not torch.equal(w, w.bfloat16().float())


# ---------------------------------------------------------------------------
# (d) Trainer.fit in bf16 against JAX's bf16 fit
# ---------------------------------------------------------------------------

class _PresetGuidedTask(JGuidedTask):
    """The JAX step-2 task of a given model, initialised to a given
    variable tree."""

    def __init__(self, variables, **model_kw):
        super().__init__(JGuided(**model_kw))
        self.variables = variables

    def init_variables(self, rng, batch):
        return jax.tree.map(jnp.copy, self.variables)  # the trainer donates its state


def test_bf16_trainer_fit_matches_jax_bf16_fit():
    train, val, kw, opt = _fit_case()
    v0 = _init_variables(16, 32, seed=6)
    jfit = lambda **m: JTrainer(_PresetGuidedTask(v0, **m), JTrainConfig(**kw, optimizer=JOptimizerConfig(**opt)),
                                log_fn=lambda s: None).fit(train, val)
    want32, want16 = jfit(backend="xla"), jfit(**JBF16)
    start = from_jax_variables(v0)
    model = GuidedDepthNet(device="cpu", dtype=BF16)
    model.load_state_dict({k: t for k, t in start.items() if not k.startswith("step1.")}, strict=False)
    step1 = {k[len("step1."):]: t for k, t in start.items() if k.startswith("step1.")}
    trainer = Trainer(GuidedTask(model, step1_state=step1), TrainConfig(**kw, optimizer=OptimizerConfig(**opt)),
                      log_fn=lambda s: None, device="cpu")
    got = trainer.fit(train, val)
    for key in ("train_loss", "val_loss"):
        for a, w32, w16 in zip(got.history[key], want32.history[key], want16.history[key]):
            assert abs(a - w32) / w32 <= max(1e-3, 2 * abs(w16 - w32) / w32), (key, a, w32, w16)
    sd32, sd16 = from_jax_variables(want32.best_variables), from_jax_variables(want16.best_variables)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for name, t in got.best_variables.items():
        assert t.dtype == torch.float32, name
        if name.startswith("step1."):
            assert torch.equal(t, start[name]), name
            assert torch.equal(model.state_dict()[name], start[name]), name
        bar = max(1e-3, 2 * rel(sd16[name].numpy(), sd32[name].numpy()))
        assert rel(t.numpy(), sd32[name].numpy()) <= bar, name


# ---------------------------------------------------------------------------
# (e) metrics and evaluate
# ---------------------------------------------------------------------------

def _pred_gt(seed, shape=(2, 16, 24, 1)):
    """A prediction with some non-positive pixels and a ground truth with
    invalid (gt == 0) pixels."""
    rng = np.random.default_rng(seed)
    gt = (1 + 9 * rng.random(shape)) * (rng.random(shape) < 0.7)
    pred = gt * (1 + 0.3 * rng.standard_normal(shape)) + rng.standard_normal(shape) * (rng.random(shape) < 0.05)
    return pred.astype(np.float32), gt.astype(np.float32)


def test_metrics_match_jax():
    pred, gt = _pred_gt(0)
    assert (gt == 0).any() and (pred <= 0).any()
    want = jmetrics.compute_all(jnp.asarray(pred), jnp.asarray(gt))
    got = metrics.compute_all(torch.from_numpy(pred), torch.from_numpy(gt))
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k
    assert float(metrics.rel_rmse(torch.from_numpy(pred), torch.from_numpy(gt))) == pytest.approx(
        float(jmetrics.rel_rmse(jnp.asarray(pred), jnp.asarray(gt))), rel=1e-6)
    empty = np.zeros_like(gt)  # no valid pixel: the masked mean is 0, not NaN
    assert float(metrics.mae(torch.from_numpy(pred), torch.from_numpy(empty))) == 0.0


def test_evaluate_averages_per_batch_as_jax_does():
    batches = [dict(zip(("pred", "gt"), _pred_gt(s, (1, 8, 8, 1)))) for s in (1, 2, 3)]
    want = jevaluate(lambda b: jnp.asarray(b["pred"]), batches, max_batches=2)
    got = evaluate(lambda b: torch.from_numpy(b["pred"]), batches, max_batches=2)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    with pytest.raises(ValueError, match="empty"):
        evaluate(lambda b: torch.from_numpy(b["pred"]), [])


def test_predict_makers_match_jax():
    """``make_unguided_predict`` and ``make_guided_predict`` (single stream,
    finest scale, BN on its running statistics, no graph) and ``evaluate``
    over them against the JAX package's."""
    v = _init_variables(16, 32, seed=9)
    batches = [guided_batch(60 + i, 2, 16, 32) for i in range(2)]
    guided = GuidedDepthNet(device="cpu")
    guided.load_state_dict(from_jax_variables(v))
    step1 = NConvUNet(device="cpu")
    step1.load_state_dict(from_jax_variables({"params": v["params"]["step1"]}))
    for port, jax_pred in ((make_unguided_predict(step1), jmake_unguided_predict({"params": v["params"]["step1"]},
                                                                                  JNConvUNet())),
                           (make_guided_predict(guided.train()), jmake_guided_predict(v, JGuided()))):
        pred = port(batches[0])
        assert not pred.requires_grad and pred.shape == (2, 16, 32, 1)
        assert rel(pred.numpy(), jax_pred(batches[0])) <= 1e-5
        got, want = evaluate(port, batches), jevaluate(jax_pred, batches)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert guided.training  # the guided predict ran in eval mode (the values above) and restored the mode


# ---------------------------------------------------------------------------
# (f) the bf16 forms of the gradient wrappers on the CPU
# ---------------------------------------------------------------------------

def test_bf16_gradient_wrappers_round_check_geometry_and_refuse_mixed_dtypes():
    r = lambda *s: torch.randn(*s).to(BF16)
    cot, w3 = r(1, 4, 6, 10), r(4, 2, 3, 3)
    got = ops.conv2d_input_grad(cot, w3, 1)
    assert got.dtype == BF16 and torch.equal(got, ops.conv2d_input_grad(cot.float(), w3.float(), 1).to(BF16))
    got = ops.conv3x3s2_input_grad(cot, w3)
    assert got.dtype == BF16 and torch.equal(got, ops.conv3x3s2_input_grad(cot.float(), w3.float()).to(BF16))
    up, w4 = r(1, 4, 6, 10), r(2, 4, 4, 4)
    got = ops.conv_transpose4x4s2_input_grad(up, w4)
    assert got.dtype == BF16 and got.shape == (1, 2, 3, 5)
    dw = ops.conv2d_wgrad([r(1, 2, 12, 20)], [cot], 3, stride=2, padding=1)
    assert dw.dtype == torch.float32 and dw.shape == (4, 2, 3, 3)
    for bad in (lambda: ops.conv2d_input_grad(cot, w3.float(), 1),
                lambda: ops.conv3x3s2_input_grad(cot.float(), w3),
                lambda: ops.conv_transpose4x4s2_input_grad(up, w4.float()),
                lambda: ops.conv2d_wgrad([r(1, 2, 12, 20)], [cot.float()], 3, stride=2, padding=1),
                lambda: ops.conv2d_wgrad([r(1, 2, 12, 20), r(1, 2, 12, 20).float()], [cot], 3, stride=2,
                                         padding=1)):
        with pytest.raises(TypeError):
            bad()
    with pytest.raises(ValueError):  # K2's bf16 K x K form takes k = 3 at stride 1 only
        ops.conv2d_input_grad(cot, r(4, 2, 5, 5), 2)
    with pytest.raises(ValueError):  # a (4, 2, 3, 3) weight does not fit 2 cotangent channels
        ops.conv3x3s2_input_grad(cot[:, :2], w3)
    with pytest.raises(ValueError):  # (6, 10) is not the stride-1 output of (12, 20)
        ops.conv2d_wgrad([r(1, 2, 12, 20)], [cot], 3, stride=1, padding=1)
