"""The port's learning-rate x weight-decay grid against the JAX package's,
on the CPU: ``grid_search`` from the same JAX initial weights
(``convert.from_jax_unguided_variables``) tracks ``nconv_tpu``'s within
1e-4 rel per epoch (``lr`` within 1e-6) with the same winner; the lockstep
``parallel_grid_search`` is bitwise the serial grid on the same batches;
a rerun skips finished cells, reloads the winner, and raises when the
winner's file is gone. 4 cells x 2 epochs of step 1 at 48x64."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nconv_tpu.models import NConvUNet as JUNet
from nconv_tpu.training import GridSearchConfig as JGrid
from nconv_tpu.training import OptimizerConfig as JOptimizerConfig
from nconv_tpu.training import TrainConfig as JTrainConfig
from nconv_tpu.training import UnguidedTask as JUnguidedTask
from nconv_tpu.training import grid_search as jgrid_search
from nconv_tpu_torch.convert import from_jax_unguided_variables
from nconv_tpu_torch.models import NConvUNet
from nconv_tpu_torch.training import (
    GridSearchConfig,
    OptimizerConfig,
    TrainConfig,
    UnguidedTask,
    grid_search,
    parallel_grid_search,
)

H, W = 48, 64
LRS, WDS = (1e-2, 1e-3), (1e-7, 1e-2)
UNET_LAYERS = [("nconv1", 5, 1, 8), ("nconv2", 5, 8, 8), ("nconv_down1", 5, 8, 8),
               ("nconv_down2", 5, 8, 8), ("nconv_down3", 5, 8, 8), ("nconv4", 3, 16, 8),
               ("nconv5", 3, 16, 8), ("nconv6", 3, 16, 8), ("nconv7", 1, 8, 1)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quiet(_msg):
    pass


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def unet_variables(seed):
    """A JAX ``NConvUNet`` variable tree from numpy (raw kernels U[0, 1),
    biases 0.01), built by hand: tracing the flax init is slow on the CPU."""
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
        return jax.tree.map(jnp.copy, self.variables)


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    truth = np.fromfunction(lambda n, i, j, c: 2 + np.sin(i / 10) + np.cos(j / 12), (b, H, W, 1)).astype(np.float32)
    return {"depth": truth * (rng.random((b, H, W, 1)) < 0.15).astype(np.float32), "gt": truth}


TRAIN = [_batch(s) for s in (1, 2, 3)]
VAL = [_batch(9)]


def train_loader():
    return iter(TRAIN)


def val_loader():
    return iter(VAL)


CFG = dict(epochs=2, batch_size=2, log_every=0)
V0 = unet_variables(0)


def port_factory():
    model = NConvUNet(device="cpu")
    model.load_state_dict(from_jax_unguided_variables(V0))
    return UnguidedTask(model)


def port_cfg(**kw):
    return TrainConfig(**{**CFG, **kw}, optimizer=OptimizerConfig("adamw", 1e-2, 1e-7))


@pytest.fixture(scope="module")
def jax_grid(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_grid")
    cfg = JTrainConfig(**CFG, optimizer=JOptimizerConfig("adamw", 1e-2, 1e-7))
    best, lr, wd = jgrid_search(lambda: _PresetTask(V0), cfg, JGrid(LRS, WDS), train_loader, val_loader,
                                log_fn=quiet, checkpoint_dir=str(d))
    with open(d / "grid_results.json") as f:
        return best, lr, wd, json.load(f)


@pytest.fixture(scope="module")
def port_grid(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_grid")
    best, lr, wd = grid_search(port_factory, port_cfg(), GridSearchConfig(LRS, WDS), train_loader, val_loader,
                               log_fn=quiet, checkpoint_dir=str(d), device="cpu")
    with open(d / "grid_results.json") as f:
        return best, lr, wd, json.load(f)


def test_grid_search_tracks_the_jax_grid(jax_grid, port_grid):
    jbest, jlr, jwd, jcells = jax_grid
    best, lr, wd, cells = port_grid
    assert (lr, wd) == (jlr, jwd)
    assert set(cells) == set(jcells) and len(cells) == 4
    for name, rec in cells.items():
        h, jh = rec["history"], jcells[name]["history"]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(h[key], jh[key], rtol=1e-4, err_msg=f"{name} {key}")
        np.testing.assert_allclose(h["lr"], jh["lr"], rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(best.best_val_loss, jbest.best_val_loss, rtol=1e-4)
    want = from_jax_unguided_variables(jbest.best_variables)
    for name, p in best.best_variables.items():  # the bar of tests/test_torch_training.py's fit
        assert rel(p.numpy(), want[name].numpy()) <= 1e-4, name


def test_parallel_grid_search_is_bitwise_the_serial_grid(port_grid):
    best_s, lr_s, wd_s, serial_cells = port_grid
    best_p, lr_p, wd_p = parallel_grid_search(port_factory, port_cfg(), GridSearchConfig(LRS, WDS),
                                              train_loader, val_loader, log_fn=quiet, device="cpu")
    assert (lr_p, wd_p) == (lr_s, wd_s)
    assert best_p.best_val_loss == best_s.best_val_loss
    cells = best_p.history["cells"]
    assert list(cells) == list(serial_cells)
    for name, h in cells.items():
        assert h == serial_cells[name]["history"], name
    assert {k: v for k, v in best_p.history.items() if k != "cells"} == cells[f"lr{lr_p:g}_wd{wd_p:g}"]
    assert best_p.best_variables.keys() == best_s.best_variables.keys()
    for name, p in best_p.best_variables.items():
        assert torch.equal(p, best_s.best_variables[name]), name


def test_grid_search_resumes_without_retraining(tmp_path):
    ckdir = str(tmp_path / "grid")
    grid = GridSearchConfig(LRS, (1e-7,))
    cfg = port_cfg(epochs=1)
    best1, lr1, wd1 = grid_search(port_factory, cfg, grid, train_loader, val_loader, log_fn=quiet,
                                  checkpoint_dir=ckdir, device="cpu")
    assert best1.best_variables is not None
    msgs = []
    best2, lr2, wd2 = grid_search(port_factory, cfg, grid, train_loader, val_loader, log_fn=msgs.append,
                                  checkpoint_dir=ckdir, device="cpu")
    assert sum("skipping" in m for m in msgs) == 2
    assert (lr2, wd2) == (lr1, wd1)
    assert best2.best_val_loss == best1.best_val_loss
    for name, p in best1.best_variables.items():
        assert torch.equal(p, best2.best_variables[name]), name

    (tmp_path / "grid" / f"lr{lr1:g}_wd{wd1:g}" / "best_variables.pt").unlink()
    with pytest.raises(FileNotFoundError, match="best_variables.pt is missing"):
        grid_search(port_factory, cfg, grid, train_loader, val_loader, log_fn=quiet,
                    checkpoint_dir=ckdir, device="cpu")
