"""Data parallelism of the port (``nconv_tpu_torch/parallel``) on the CPU.

Multi-rank cases run in one gloo group of 2 CPU ranks a module: this file,
run as a script, is the rank's program (it imports neither jax nor the JAX
package), and the module fixture starts both ranks once and reads what they
wrote. Every rank builds its model from another seed, so that the
broadcast from rank 0 is what makes them equal. Bars: the sharded
gradients equal the single-process gradients of the whole batch at rtol
1e-5 (with a floor of 1e-5 of each gradient's largest element, and the
gradients that train-mode BN makes zero held to rounding); the sharded SGD step equals JAX's
``Trainer`` on a 2-device mesh on the loss (1e-4) and on each parameter's
update under plain SGD (which scales with the gradient, as the parameters
after a step barely do), relative RMSE at 1e-4 or, where the f32 rounding
of an update is larger (a normalized conv's weight gradient cancels), at
4x the larger f32 distance of the two whole-batch steps (JAX's, and the
port's in one process) from the port's float64 step (PERF.md section 2), a
bar the sharded step does not set.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nconv_tpu_torch import parallel
from nconv_tpu_torch.models import GuidedDepthNet, NConvUNet
from nconv_tpu_torch.training import (
    CheckpointManager, GridSearchConfig, GuidedTask, OptimizerConfig, TrainConfig, Trainer, UnguidedTask,
    parallel_grid_search,
)

H, W = 16, 32  # step 1 and the guided net both take multiples of 8
B = 4
WORLD = 2
SGD0 = dict(name="sgd", learning_rate=0.0, weight_decay=0.0, momentum=0.0)  # the step leaves the gradients
# plain SGD at a rate that makes every update far larger than its
# parameter's f32 spacing, so the update is read to 1e-4 of itself
SGD = dict(name="sgd", learning_rate=1e3, weight_decay=0.0, momentum=0.0)


def step1_batch(seed, b=B):
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    truth = (2 + np.sin(i / 5)[None] * rng.random((b, 1, 1)) + np.cos(j / 6)[None]).astype(np.float32)[..., None]
    return {"depth": truth * (rng.random((b, H, W, 1)) < 0.3).astype(np.float32), "gt": truth}


def guided_batch(seed, b=B):
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    truth = (2 + np.sin(i / 5)[None] * rng.random((b, 1, 1)) + np.cos(j / 6)[None]).astype(np.float32)[..., None]
    rgb = (rng.random((b, H, W, 3)) * 255).astype(np.float32)
    return {"rgb": rgb, "depth": truth * (rng.random((b, H, W, 1)) < 0.1).astype(np.float32), "gt": truth}


def guided_task(state, seed):
    model = GuidedDepthNet(device="cpu", seed=seed)
    if state is not None:
        model.load_state_dict(state)
    return GuidedTask(model)


def unguided_task(state, seed):
    model = NConvUNet(device="cpu", seed=seed)
    if state is not None:
        model.load_state_dict(state)
    return UnguidedTask(model)


def grads_of(trainer):
    return {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None}


def one_step(task, batch, opt, mesh=None, **cfg):
    """One ``Trainer.train_step``: (loss, gradients, state after)."""
    trainer = Trainer(task, TrainConfig(optimizer=OptimizerConfig(**opt), log_every=0, **cfg),
                      log_fn=lambda m: None, device="cpu", mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in (batch if mesh is None else parallel.shard_batch(batch, mesh)).items()}
    loss = trainer.train_step(batch)
    return float(loss), grads_of(trainer), {k: v.clone() for k, v in trainer.model.state_dict().items()}


# ---------------------------------------------------------------------------
# The rank's program
# ---------------------------------------------------------------------------

def rank_main(rank: int, port: int, work: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=WORLD)
    mesh = parallel.make_mesh(devices=["cpu"])
    assert (mesh.rank, mesh.world) == (rank, WORLD)
    inp = torch.load(work / "inputs.pt", weights_only=False)
    seed = 10 + rank  # rank 1 starts elsewhere: the trainer broadcasts rank 0's state
    out = {
        "step1": one_step(unguided_task(None, seed), inp["step1_batch"], SGD0, mesh),
        "guided": one_step(guided_task(None, seed), inp["guided_batch"], SGD0, mesh),
        "guided_first": one_step(guided_task(None, seed), inp["guided_batch"], SGD0, mesh, batch_reduce="first"),
        "step1_sgd": one_step(unguided_task(inp["step1_state"], seed), inp["step1_batch"], SGD, mesh),
        "guided_sgd": one_step(guided_task(inp["guided_state"], seed), inp["guided_batch"], SGD, mesh),
    }
    try:
        parallel.shard_batch(step1_batch(0, b=3), mesh)
    except ValueError as e:
        out["ragged"] = str(e)
    ck = CheckpointManager(work / f"ckpt{rank}", keep=2)
    train = [step1_batch(20), step1_batch(21)]
    trainer = Trainer(unguided_task(None, seed), TrainConfig(epochs=2, log_every=0), checkpoints=ck,
                      log_fn=lambda m: out.setdefault("log", []).append(m), device="cpu", mesh=mesh)
    fit = trainer.fit(lambda: iter(train), lambda: iter(train[:1]), resume=False)
    out["fit"] = (fit.history, fit.best_val_loss)
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The 2-rank run, once a module
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_init():
    """JAX initial variables (numpy-filled), and the port's state of each."""
    import jax.numpy as jnp

    from nconv_tpu.models import GuidedDepthNet as JGuided
    from nconv_tpu_torch.convert import from_jax_unguided_variables, from_jax_variables
    from test_torch_guided_training import random_variables
    from test_torch_training import unet_variables

    z3, z1 = jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 1))
    v_guided = random_variables(JGuided(), z3, z1, z3, z1, seed=4)
    v_step1 = unet_variables(3)
    return {"step1": (v_step1, from_jax_unguided_variables(v_step1)),
            "guided": (v_guided, from_jax_variables(v_guided))}


@pytest.fixture(scope="module")
def ranks(jax_init, tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    torch.save({"step1_batch": step1_batch(1), "guided_batch": guided_batch(2),
                "step1_state": jax_init["step1"][1], "guided_state": jax_init["guided"][1]}, work / "inputs.pt")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(Path(__file__).resolve().parents[1]),
                                                         os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(work)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return work, [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_grads_equal(got: dict, want: dict, rtol=1e-5):
    """Each gradient at ``rtol``, elementwise with an absolute floor of
    ``rtol`` x its largest element; a gradient that is zero up to rounding
    (a conv bias in front of a train-mode BN: under 1e-6 of the model's
    largest gradient element) must be that small on both sides."""
    assert got.keys() == want.keys()
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        w = want[name]
        scale = w.abs().max().item()
        if scale < floor:
            assert g.abs().max().item() < floor, name
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("case", ["step1", "guided", "guided_first"])
def test_sharded_gradients_equal_the_whole_batch_gradients(case, ranks):
    """Rank 0's model (seed 10), one step on the whole batch in one process
    against the averaged gradients of the 2-rank step; both ranks hold the
    same gradients, the same loss and, with train-mode BN, the same new
    running statistics."""
    _, outs = ranks
    if case == "step1":
        want = one_step(unguided_task(None, 10), step1_batch(1), SGD0)
    else:
        want = one_step(guided_task(None, 10), guided_batch(2), SGD0,
                        batch_reduce="first" if case == "guided_first" else "mean")
    loss, grads, state = want
    for out in outs:
        got_loss, got_grads, got_state = out[case]
        assert got_loss == pytest.approx(loss, rel=1e-6)
        assert_grads_equal(got_grads, grads)
        for k in state:
            np.testing.assert_allclose(got_state[k].numpy(), state[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
    for k, g in outs[0][case][1].items():
        assert torch.equal(g, outs[1][case][1][k]), k


def _jax_step(task, batch, v0):
    """One step of JAX's ``Trainer`` on a 2-device mesh: (loss, variables
    after)."""
    import jax

    from nconv_tpu.parallel import make_mesh
    from nconv_tpu.training import OptimizerConfig as JOptimizerConfig
    from nconv_tpu.training import TrainConfig as JTrainConfig
    from nconv_tpu.training import Trainer as JTrainer

    trainer = JTrainer(task, JTrainConfig(optimizer=JOptimizerConfig(**SGD)), mesh=make_mesh(n_data=2),
                       log_fn=lambda m: None)
    trainer._build_steps()
    state = trainer.init_state(jax.random.key(0), batch)
    params, stats, _, loss = trainer._train_step(state["params"], state["batch_stats"], state["opt_state"],
                                                 trainer._device_batch(batch))
    return float(loss), {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("case", ["step1", "guided"])
def test_sharded_sgd_step_matches_jax_trainer_on_a_two_device_mesh(case, ranks, jax_init):
    import jax
    import jax.numpy as jnp

    from nconv_tpu.models import GuidedDepthNet as JGuided
    from nconv_tpu.models import NConvUNet as JUNet
    from nconv_tpu.training import GuidedTask as JGuidedTask
    from nconv_tpu.training import UnguidedTask as JUnguidedTask
    from nconv_tpu_torch.convert import from_jax_unguided_variables, from_jax_variables

    v0, start = jax_init[case]

    class Preset(JUnguidedTask if case == "step1" else JGuidedTask):
        def init_variables(self, rng, batch):
            return jax.tree.map(jnp.copy, v0)

    if case == "step1":
        task, batch, convert = Preset(JUNet(backend="xla")), step1_batch(1), from_jax_unguided_variables
    else:
        task, batch, convert = Preset(JGuided(backend="xla")), guided_batch(2), from_jax_variables
    want_loss, after = _jax_step(task, batch, v0)
    want = convert(jax.tree.map(np.asarray, after))
    _, outs = ranks
    got_loss, _, got = outs[0][f"{case}_sgd"]
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    # the f32 rounding of each update: the larger of the two whole-batch f32
    # steps' distances from the port's float64 step, JAX's and the port's in
    # one process (never read from the sharded step under test, whose own
    # error would widen its bar)
    make = unguided_task if case == "step1" else guided_task
    _, _, got32 = one_step(make(start, 0), batch, SGD)
    task64 = make(start, 0)
    task64.model.double()
    _, _, got64 = one_step(task64, {k: v.astype(np.float64) for k, v in batch.items()}, SGD)
    delta = lambda state: {n: (state[n].double() - start[n].double()).numpy() for n in got}
    deltas, want_deltas, deltas32, deltas64 = delta(got), delta(want), delta(got32), delta(got64)
    floor = 1e-6 * max(np.abs(d).max() for d in want_deltas.values())
    moved = 0
    for name, d in deltas.items():
        if np.abs(want_deltas[name]).max() < floor:  # frozen step 1, BN statistics, zero gradients
            assert np.abs(d).max() < floor, name
            continue
        rounding = max(rel(deltas32[name], deltas64[name]), rel(want_deltas[name], deltas64[name]))
        assert rel(d, want_deltas[name]) <= max(1e-4, 4 * rounding), name
        moved += 1
    assert moved > len(got) // 2


def test_batch_reduce_first_reads_global_element_zero(ranks):
    """With ``batch_reduce="first"`` the loss is element 0's, which lives
    on rank 0: rank 1's shard changes nothing but the BN statistics."""
    _, outs = ranks
    first, mean = outs[0]["guided_first"][0], outs[0]["guided"][0]
    assert first != pytest.approx(mean, rel=1e-3)
    assert outs[1]["guided_first"][0] == first


def test_a_batch_that_does_not_split_evenly_raises(ranks):
    _, outs = ranks
    assert outs[0]["ragged"] == outs[1]["ragged"] == "batch of 3 does not split evenly over 2 ranks"


def test_rank_zero_alone_writes_checkpoints_and_logs(ranks):
    work, outs = ranks
    assert not (work / "ckpt1").exists() or not any((work / "ckpt1").iterdir())
    ck = CheckpointManager(work / "ckpt0")
    assert ck.latest_epoch() == 1
    state, _ = ck.restore(1)
    assert state["model"] and not any(k.startswith("module.") for k in state["model"])
    best = ck.load_best_variables()
    assert best and not any(k.startswith("module.") for k in best)
    assert outs[0]["log"] and "log" not in outs[1]
    assert outs[0]["fit"] == outs[1]["fit"]


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

def test_pad_batch_to_is_bitwise_the_jax_packages():
    from nconv_tpu.parallel import pad_batch_to as jpad

    rng = np.random.default_rng(0)
    batch = {"x": rng.random((5, 3)).astype(np.float32), "a": rng.integers(0, 9, (5, 2, 2)).astype(np.uint16),
             "n": {"z": rng.random((5,))}}
    for size in (5, 8):
        got, n = parallel.pad_batch_to(batch, size)
        want, jn = jpad(batch, size)
        assert n == jn == 5
        for k in ("x", "a"):
            assert got[k].dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["n"]["z"], want["n"]["z"])
        assert (got["x"] is batch["x"]) == (size == 5)


def test_make_mesh_without_a_group_is_world_one():
    mesh = parallel.make_mesh(devices=["cpu", "cpu"])
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    assert mesh.shape == {parallel.DATA_AXIS: 2, parallel.MODEL_AXIS: 1} and mesh.device == torch.device("cpu")
    assert parallel.make_mesh(n_data=1, devices=["cpu", "cpu"]).devices == (torch.device("cpu"),)
    batch = step1_batch(0, b=3)
    assert parallel.shard_batch(batch, mesh) is batch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            parallel.make_mesh()


@pytest.mark.parametrize("case", ["step1", "guided"])
def test_world_one_mesh_is_bitwise_the_plain_trainer(case):
    mesh = parallel.make_mesh(devices=["cpu"])
    task, batch = (unguided_task, step1_batch(1)) if case == "step1" else (guided_task, guided_batch(2))
    opt = dict(name="adamw", learning_rate=1e-3, weight_decay=1e-7)
    loss, grads, state = one_step(task(None, 5), batch, opt, mesh)
    want_loss, want_grads, want_state = one_step(task(None, 5), batch, opt)
    assert loss == want_loss
    for k in want_grads:
        assert torch.equal(grads[k], want_grads[k]), k
    for k in want_state:
        assert torch.equal(state[k], want_state[k]), k


def _rigs(n, seed, h, w):
    rng = np.random.default_rng(seed)
    truth = np.fromfunction(lambda b, i, j, c: 2 + np.sin(i / 10) + np.cos(j / 12), (n, h, w, 1)).astype(np.float32)
    rgb = [(rng.random((n, h, w, 3)) * 255).astype(np.float32) for _ in range(2)]
    d = [(truth * (rng.random((n, h, w, 1)) < 0.15)).astype(np.float32) for _ in range(2)]
    return rgb[0], d[0], rgb[1], d[1]


def test_data_parallel_engine_pads_and_matches_per_rig_export():
    """Two CPU replicas, N = 3 rigs (padded to 4): each rig within 1e-6 of
    the port's own ``export`` on that rig and within 1e-4 of the JAX
    package's folded ``GuidedDepthNet.export``."""
    import jax
    import jax.numpy as jnp

    from nconv_tpu.models import GuidedDepthNet as JGuided
    from nconv_tpu.models import fold_batchnorm_variables
    from nconv_tpu_torch.convert import from_jax_variables
    from test_torch_guided_training import random_variables

    h, w = 104, 64  # rows 45..58 outside the sensor border
    z3, z1 = jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w, 1))
    v = random_variables(JGuided(), z3, z1, z3, z1, seed=7)
    state = from_jax_variables(v)
    engine = parallel.DataParallelEngine(state, height=h, width=w, devices=["cpu", "cpu"])
    assert engine.n_data == 2 and engine.replicas[0] is not engine.replicas[1]
    r0, d0, r1, d1 = _rigs(3, 8, h, w)
    out0, out1 = engine(r0, d0[..., 0], r1, d1)
    assert out0.shape == out1.shape == (3, h, w, 1) and out0.dtype == torch.float32
    single = parallel.DataParallelEngine(state, height=h, width=w, devices=["cpu"]).replicas[0]
    jmodel = JGuided(fold_bn=True, backend="xla")
    jexport = jax.jit(lambda a, b, c, d: jmodel.apply(fold_batchnorm_variables(v), a, b, c, d,
                                                      method=JGuided.export))
    for i in range(3):
        rig = [torch.from_numpy(a[i:i + 1]) for a in (r0, d0, r1, d1)]
        with torch.no_grad():
            want = single.export(*rig)
        jwant = jexport(*(a[i:i + 1] for a in (r0, d0, r1, d1)))
        for got, pw, jw in zip((out0, out1), want, jwant):
            g = got[i:i + 1].numpy()
            assert np.linalg.norm(g - pw.numpy()) <= 1e-6 * np.linalg.norm(pw.numpy())
            assert np.linalg.norm(g - np.asarray(jw)) <= 1e-4 * np.linalg.norm(np.asarray(jw))
    assert float(out0.abs().sum()) > 0


def test_parallel_grid_over_two_devices_is_bitwise_the_one_device_grid():
    train = [step1_batch(30), step1_batch(31)]
    cfg = TrainConfig(epochs=2, log_every=0, optimizer=OptimizerConfig("adamw", 1e-2, 1e-7))
    grid = GridSearchConfig(learning_rates=(1e-2, 3e-3), weight_decays=(1e-7, 1e-4))
    runs = [parallel_grid_search(lambda: unguided_task(None, 2), cfg, grid, lambda: iter(train),
                                 lambda: iter(train[:1]), log_fn=lambda m: None, **kw)
            for kw in (dict(device="cpu"), dict(devices=["cpu", "cpu"]), dict(devices=["cpu"] * 3))]
    (want, lr, wd), *others = runs
    for got, glr, gwd in others:
        assert (glr, gwd) == (lr, wd)
        assert got.history == want.history and got.best_val_loss == want.best_val_loss
        for k, t in want.best_variables.items():
            assert torch.equal(got.best_variables[k], t), k


def test_tables_key_on_the_device():
    """A table is built for each device it is asked on (two device keys:
    the CPU and the meta device), and each lives on its own."""
    from nconv_tpu_torch.models import border_mask
    from nconv_tpu_torch.ops import resize
    from nconv_tpu_torch.ops.tables import TABLES

    builds = TABLES.builds
    cpu, meta = (border_mask(98, 12, device=d) for d in ("cpu", "meta"))
    assert (cpu.device.type, meta.device.type) == ("cpu", "meta")
    lo_cpu = resize._linear_table(7, 5, False, torch.device("cpu"), torch.float32)[0]
    lo_meta = resize._linear_table(7, 5, False, torch.device("meta"), torch.float32)[0]
    assert (lo_cpu.device.type, lo_meta.device.type) == ("cpu", "meta")
    assert TABLES.builds - builds == 4
    assert border_mask(98, 12, device="cpu") is cpu


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
