"""Data parallelism over ``torch.distributed`` (the JAX package's
``parallel/mesh.py``).

The JAX package shards the batch over a mesh's ``data`` axis and lets XLA's
SPMD partitioner form every batch reduction over the whole batch. Here one
process drives one device (``torchrun``, one process per GPU), a
:class:`Mesh` names this process's device, its process group, rank and
world size, and the batch reductions that do not split into per-rank pieces
are made global by hand: the loss's ``sqrt(mse)`` and train-mode
BatchNorm's batch mean and variance (``models/layers.py``, ``losses.py``)
sum their local pieces through :func:`all_sum` while a :func:`data_parallel`
context is active. The trainer then averages the parameter gradients over
the ranks (:func:`average_gradients`), so that a step equals the
single-process step on the whole batch. At world size 1 no collective
runs, and every path is the single-device one.

Checkpoints carry no ``module.`` prefix: no module is wrapped.

Not ported: ``spatial_sharding``, the JAX package's split of H over a
``model`` axis (which defaults to 1 there). XLA SPMD inserts the convs'
halo exchanges for it; PyTorch has no SPMD halo exchange, and the split
buys nothing on one H100, which holds the model and a KITTI frame many
times over. ``batch_sharding`` and ``replicated`` are JAX sharding objects
that a one-process-per-device design has no use for.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"  # the JAX package's spatial axis; one device along it here (no H split)


@dataclass(frozen=True)
class Mesh:
    """The devices a data-parallel job runs on, as this process sees them.

    For training, ``devices`` holds this rank's one device, and ``group``,
    ``rank`` and ``world`` its ``torch.distributed`` process group (``None``
    at world size 1). A one-process mesh over several devices (serving,
    the grid's cells) has world size 1 and no group."""

    devices: tuple[torch.device, ...]
    group: Any = None
    rank: int = 0
    world: int = 1

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[0]

    @property
    def shape(self) -> dict[str, int]:
        """Ranks (or, in one process, devices) along each axis."""
        return {DATA_AXIS: self.world if self.group is not None else len(self.devices), MODEL_AXIS: 1}

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.group)


def _rank_device() -> torch.device:
    from ..models.backend import resolve_device  # models import this module

    if torch.cuda.is_available() and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    dev = resolve_device("cuda")
    return torch.device("cuda", torch.cuda.current_device()) if dev.index is None else dev


def make_mesh(n_data: int | None = None, devices=None) -> Mesh:
    """A mesh for this process.

    With a process group (the default group once initialised, or one this
    call initialises from ``torchrun``'s environment when ``WORLD_SIZE`` >
    1: NCCL on the card, gloo on the CPU), it is that group's rank and
    world size on this rank's device: ``devices[0]`` if given, else
    ``cuda:$LOCAL_RANK``, else the current CUDA device. Without one it is
    world size 1 over ``devices`` (default: the current CUDA device; raises
    without a GPU), cut to ``n_data`` of them."""
    devices = [torch.device(d) for d in devices] if devices is not None else None
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        cuda = (devices[0] if devices else _rank_device()).type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo")
    if dist.is_initialized():
        group = dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        if n_data is not None and n_data != world:
            raise ValueError(f"n_data {n_data} != the process group's world size {world}")
        device = devices[0] if devices else _rank_device()
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return Mesh((device,), group if world > 1 else None, rank, world)
    devices = devices or [_rank_device()]
    n_data = len(devices) if n_data is None else n_data
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"n_data {n_data} of {len(devices)} devices")
    return Mesh(tuple(devices[:n_data]))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    """Leaves in the JAX package's order (a dict's by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's contiguous slice of every array leaf's leading (batch)
    axis; leaves without a shape pass through. Raises when a batch does not
    split evenly over the ranks, as JAX's even sharding does."""
    def shard(x):
        if not hasattr(x, "shape"):
            return x
        n = x.shape[0]
        if n % mesh.world:
            raise ValueError(f"batch of {n} does not split evenly over {mesh.world} ranks")
        k = n // mesh.world
        return x[mesh.rank * k:(mesh.rank + 1) * k]

    return batch if mesh.world == 1 else _map(shard, batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` (an ``nn.Module``'s parameters and buffers,
    or a dict / list of tensors) set to rank 0's values, in place; returns
    ``tree``."""
    if mesh.world == 1:
        return tree
    tensors = (list(tree.parameters()) + list(tree.buffers()) if isinstance(tree, torch.nn.Module)
               else [t for t in _leaves(tree) if isinstance(t, torch.Tensor)])
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src, group=mesh.group)
    return tree


def pad_batch_to(batch: Any, size: int) -> Any:
    """Pad every leaf's leading axis up to ``size`` with zeros (for even
    sharding of a ragged final batch); returns ``(padded, n_real)``."""
    def _pad(x):
        n = x.shape[0]
        if n == size:
            return x
        pad = [(0, size - n)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), pad)

    leaves = _leaves(batch)
    n_real = leaves[0].shape[0] if leaves else 0
    return _map(_pad, batch), n_real


# -- the active mesh: what the batch reductions sum over -------------------------

# a context variable, so that each thread (a lockstep grid's, a server's)
# sees only the mesh it entered
_active: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar("nconv_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None) -> Iterator[None]:
    """While entered, :func:`all_sum` sums over ``mesh``'s ranks (a mesh of
    world size 1, or None, leaves every reduction local)."""
    token = _active.set(mesh if mesh is not None and mesh.world > 1 else None)
    try:
        yield
    finally:
        _active.reset(token)


def active_world() -> int:
    """The world size of the active :func:`data_parallel` mesh, else 1."""
    mesh = _active.get()
    return 1 if mesh is None else mesh.world


def active_rank() -> int:
    mesh = _active.get()
    return 0 if mesh is None else mesh.rank


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active mesh's ranks, differentiably (the
    backward sums the cotangents over the ranks too); ``t`` itself when no
    mesh of world size > 1 is active."""
    mesh = _active.get()
    if mesh is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=mesh.group)


def average_gradients(params, mesh: Mesh) -> None:
    """Each parameter's ``.grad`` set to its mean over the ranks, in one
    flat all-reduce. The losses and BatchNorm sum through :func:`all_sum`,
    whose backward sums the cotangents over the ranks, so every rank's
    gradient is ``world`` x its share of the gradient of the global loss:
    their mean is the whole batch's gradient."""
    if mesh.world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
