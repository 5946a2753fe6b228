"""Data parallelism of the port (the JAX package's ``parallel/``): a
:class:`Mesh` of devices and ranks, batch sharding and padding, and rack
serving over a replica per device. The cross-rank sums of the losses and
BatchNorm, and the gradient average, are in :mod:`.mesh`.

The names are the JAX package's, less three: ``spatial_sharding`` (an H
split over a ``model`` axis, not ported: PyTorch has no SPMD halo exchange,
and one H100 needs no split), and ``batch_sharding`` and ``replicated``,
JAX sharding objects that a one-process-per-device design has no use for.
"""
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, pad_batch_to, replicate, shard_batch
from .serving import DataParallelEngine

__all__ = [
    "DATA_AXIS", "DataParallelEngine", "MODEL_AXIS", "Mesh", "make_mesh", "pad_batch_to", "replicate",
    "shard_batch",
]
