"""Model export: the deployed forward as a ``torch.export`` program.

The port's form of the JAX package's StableHLO artifact
(``nconv_tpu/runtime/export.py``): the guided export graph, two RGB and two
sparse-depth inputs to two dense-depth outputs, named ``rgb_0, depth_0,
rgb_1, depth_1`` as in the reference's ONNX contract, f32 NHWC
``(b, H, W, 3)`` / ``(b, H, W, 1)``, saved with the weights in it as a
``.pt2`` file that reloads into a process without the model code.

The program runs the hand-written kernels: while ``torch.export`` traces,
K1-K4 enter the graph as the custom ops of :mod:`..ops.library`, whose CUDA
implementations launch the kernels (their CPU ones run the plain versions).
Everything else in the graph is plain ATen. The model's ``dtype`` plays the
part of JAX's ``compute_dtype`` (the feature convs run in it) and its device
decides where the program runs.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from ..models import GuidedDepthNet
from ..models.guided import INPUT_NAMES
from ..ops import library  # noqa: F401  (registers the ops the program calls)

__all__ = ["export_guided", "load_exported", "save_exported"]

EXAMPLE_BATCH = 2  # a dynamic axis traced at 1 is specialized to 1


class _Deployed(nn.Module):
    """``GuidedDepthNet.export`` as a module whose forward takes the
    contract's named inputs."""

    def __init__(self, model: GuidedDepthNet):
        super().__init__()
        self.model = model

    def forward(self, rgb_0, depth_0, rgb_1, depth_1):
        return self.model.export(rgb_0, depth_0, rgb_1, depth_1)


def export_guided(model: GuidedDepthNet, *, height: int, width: int,
                  batch: int | None = None) -> torch.export.ExportedProgram:
    """Trace ``model.export`` (eval mode, folded or not) into a program.

    ``batch=None`` (default) exports a dynamic batch axis, one symbol for
    all four inputs and both outputs (the reference ONNX contract): one
    program serves any batch from 1. Pass an int for a fixed batch."""
    dev = model.device
    b = EXAMPLE_BATCH if batch is None else batch
    rgb = torch.zeros((b, height, width, 3), device=dev)
    depth = torch.zeros((b, height, width, 1), device=dev)
    dynamic = None
    if batch is None:
        dim = torch.export.Dim("batch", min=1)
        dynamic = {name: {0: dim} for name in INPUT_NAMES}
    ep = torch.export.export(_Deployed(model.eval()), (rgb, depth, rgb.clone(), depth.clone()),
                             dynamic_shapes=dynamic)
    # the resize tables and the border mask are built from numpy during the
    # trace, so they enter as host constants copied to the model's device
    # on every call; keep them on that device instead
    ep = move_to_device_pass(ep, {"cpu": str(dev)})
    ep.example_inputs = None  # zeros, which the saved file need not carry (27 MB at 352x1216)
    return ep


def save_exported(ep: torch.export.ExportedProgram, path: str | os.PathLike) -> str:
    """Write the program (``torch.export.save``; a ``.pt2`` file)."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(ep, path)
    return path


def load_exported(path: str | os.PathLike):
    """Load a saved program; returns a callable ``(rgb0, d0, rgb1, d1) ->
    (depth0, depth1)`` that takes tensors or arrays, moves them to the
    program's device as f32 and runs the program without autograd. The
    callable's ``program`` attribute is the loaded ``ExportedProgram``."""
    ep = torch.export.load(os.fspath(path))
    module = ep.module()
    dev = next(iter(ep.state_dict.values())).device  # where the weights are, the program runs

    def as_input(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=dev, dtype=torch.float32)

    def call(rgb0, d0, rgb1, d1):
        with torch.no_grad():
            return module(*map(as_input, (rgb0, d0, rgb1, d1)))

    call.program = ep
    return call
