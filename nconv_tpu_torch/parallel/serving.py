"""Rack serving: N two-stream rigs a call over a replica per device (the
JAX package's ``parallel/serving.py``).

The JAX engine shards the frame batch over a mesh's ``data`` axis in one
jitted ``shard_map``. Here one process holds one folded ``GuidedDepthNet``
per device, weights replicated; a call pads N to a multiple of the device
count (:func:`.mesh.pad_batch_to`), copies each device's slice to it, runs
``GuidedDepthNet.export`` on every device before it waits on any, and
gathers the results on the first device. The forward couples no batch
rows, so nothing crosses devices but the gather.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.backend import resolve_device
from .mesh import pad_batch_to


class DataParallelEngine:
    """``engine(rgb0, d0, rgb1, d1)`` takes (N, H, W, C) stacks (RGB as
    float 0..255, depth in meters; an (N, H, W) depth gains its channel)
    and returns the two dense depth stacks (N, H, W, 1), float32 tensors on
    the first device.

    ``state`` is a ``GuidedDepthNet`` state dict (BN folded on
    construction unless ``fold_bn=False``); ``dtype=torch.bfloat16`` runs
    the mixed schedule. ``devices`` defaults to every visible GPU and may
    name one device more than once (a replica each)."""

    def __init__(self, state, *, height: int, width: int, devices=None, dtype: torch.dtype = torch.float32,
                 fold_bn: bool = True):
        from ..models import GuidedDepthNet, maybe_fold

        if devices is None:
            resolve_device("cuda")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("DataParallelEngine needs at least one device")
        self.height, self.width = height, width
        self.n_data = len(self.devices)
        self.replicas = []
        for dev in self.devices:
            model = GuidedDepthNet(dtype=dtype, device=dev)
            model, st = maybe_fold(model, state) if fold_bn else (model, dict(state))
            model.load_state_dict({k: v.to(dev) for k, v in st.items()})
            self.replicas.append(model.eval())

    def _stage(self, a: np.ndarray, channels: int, device: torch.device) -> torch.Tensor:
        if a.ndim == 3 and channels == 1:
            a = a[..., None]
        if a.shape[1:] != (self.height, self.width, channels):
            raise ValueError(f"frames {a.shape[1:]} != {(self.height, self.width, channels)}")
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    @torch.no_grad()
    def __call__(self, rgb0, depth0, rgb1, depth1):
        arrays = {"r0": rgb0, "d0": depth0, "r1": rgb1, "d1": depth1}
        arrays = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, np.float32)
                  for k, v in arrays.items()}
        n = arrays["r0"].shape[0]
        n_pad = -(-n // self.n_data) * self.n_data
        batch, _ = pad_batch_to(arrays, n_pad)
        k = n_pad // self.n_data
        staged = [[self._stage(batch[key][i * k:(i + 1) * k], c, dev)
                   for key, c in (("r0", 3), ("d0", 1), ("r1", 3), ("d1", 1))]
                  for i, dev in enumerate(self.devices)]
        outs = [model.export(*args) for model, args in zip(self.replicas, staged)]
        first = self.devices[0]
        out0 = torch.cat([o[0].to(first) for o in outs])[:n]
        out1 = torch.cat([o[1].to(first) for o in outs])[:n]
        return out0, out1
