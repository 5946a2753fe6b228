"""Emit the reference's deployment artifact: an ONNX file.

The reference ships an ONNX file for an ONNX Runtime session on the robot.
This module writes the same contract from the port's weights: inputs
``rgb_0, depth_0, rgb_1, depth_1`` (NCHW float32), outputs
``output_depth_0, output_depth_1``, a dynamic ``batch_size`` axis on all
six, opset 17, the weights as initializers. The graph is traced with
torch's TorchScript ONNX exporter from the port's own ``GuidedDepthNet``
on its plain path, on a CPU copy of the weights (a kernel launch on the
card is a ``ctypes`` call, which has no ONNX form), with step 1's kernels
made positive first, as a reference checkpoint holds them. H and W are
fixed at trace time; the batch axis stays dynamic.

Without a usable ``onnx`` package, :func:`_no_onnxscript_passthrough` makes
the exporter's last step, which splices onnxscript functions into the
serialized bytes (none in this graph) and is the only one that imports
``onnx``, the identity it is for this graph. :func:`read_onnx_summary` is
a structural check that needs no ``onnx`` either; an artifact is written
under a temporary name and moved into place only once that check passed.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import warnings
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..models import GuidedDepthNet
from ..models.guided import INPUT_NAMES
from ..ops.nconv import POS_FNS
from .onnx_exec import load_onnx_graph, run_onnx

__all__ = ["export_guided_onnx", "read_onnx_summary", "selftest_guided_onnx"]

OUTPUT_NAMES = ["output_depth_0", "output_depth_1"]
OPSET = 17
BATCH_AXIS = "batch_size"

# where torch has kept the legacy exporter's onnxscript-splice step
_PROTO_UTILS = (
    "torch.onnx._internal.torchscript_exporter.onnx_proto_utils",
    "torch.onnx._internal.onnx_proto_utils",
)


def _usable(name: str, attr: str):
    """The module ``name`` if it imports and has ``attr`` (a bare import can
    find an unrelated namespace package of that name), else None."""
    try:
        module = importlib.import_module(name)
    except ImportError:
        return None
    return module if hasattr(module, attr) else None


@contextlib.contextmanager
def _no_onnxscript_passthrough():
    """Without a usable ``onnx``, make the exporter's onnxscript splice the
    identity it already is for this graph; raises if this torch keeps that
    step in none of the places it has had."""
    if _usable("onnx", "load_model_from_string"):
        yield
        return
    utils = next((m for m in map(lambda n: _usable(n, "_add_onnxscript_fn"), _PROTO_UTILS) if m), None)
    if utils is None:
        raise RuntimeError(f"no onnx package, and none of {_PROTO_UTILS} has _add_onnxscript_fn: "
                           "cannot run torch's TorchScript ONNX exporter here")
    original = utils._add_onnxscript_fn
    utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        yield
    finally:
        utils._add_onnxscript_fn = original


class _Nchw(nn.Module):
    """``GuidedDepthNet.export`` with the contract's NCHW inputs and
    outputs."""

    def __init__(self, model: GuidedDepthNet):
        super().__init__()
        self.model = model

    def forward(self, rgb_0, depth_0, rgb_1, depth_1):
        nhwc = [t.permute(0, 2, 3, 1) for t in (rgb_0, depth_0, rgb_1, depth_1)]
        return tuple(o.permute(0, 3, 1, 2) for o in self.model.export(*nhwc))


def positive_cpu_model(model_or_state, kernel_mode: str = "softplus") -> GuidedDepthNet:
    """A float32 CPU ``GuidedDepthNet`` with step 1's kernels already
    positive (``step1_pos_fn='identity'``), computing what
    ``model_or_state`` computes: a model's own ``step1_pos_fn``, or for a
    port state dict (unfolded or folded) the one ``kernel_mode`` names
    ('softplus', or 'raw' for kernels held positive)."""
    if isinstance(model_or_state, GuidedDepthNet):
        state, pos_fn = model_or_state.state_dict(), model_or_state.config["step1_pos_fn"]
    else:
        if kernel_mode not in ("softplus", "raw"):
            raise ValueError(f"unknown kernel_mode {kernel_mode!r}")
        state, pos_fn = model_or_state, "softplus" if kernel_mode == "softplus" else "identity"
    state = {k: v.detach().to("cpu", torch.float32) for k, v in state.items()}
    for k in state:
        if k.startswith("step1.") and k.endswith(".weight"):
            state[k] = POS_FNS[pos_fn](state[k])
    folded = not any(k.endswith(".bn.running_mean") for k in state)
    model = GuidedDepthNet(step1_pos_fn="identity", fold_bn=folded, device="cpu")
    model.load_state_dict(state)
    return model.eval()


def export_guided_onnx(model_or_state, path: str, *, height: int = 480, width: int = 640,
                       kernel_mode: str = "softplus") -> str:
    """Write a ``GuidedDepthNet`` (or a port state dict, see
    :func:`positive_cpu_model`) as a deployment ONNX file traced at
    ``height`` x ``width`` (the reference traces 480x640); the batch axis
    stays dynamic. Returns ``path``."""
    model = _Nchw(positive_cpu_model(model_or_state, kernel_mode))
    rgb, dep = torch.zeros(1, 3, height, width), torch.zeros(1, 1, height, width)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with _no_onnxscript_passthrough(), torch.no_grad(), warnings.catch_warnings():
            # H and W are trace-time constants on purpose (only the batch
            # axis is dynamic), which is what the tracer's warnings describe
            warnings.simplefilter("ignore", torch.jit.TracerWarning)
            torch.onnx.export(model, (rgb, dep, rgb.clone(), dep.clone()), tmp, export_params=True,
                              opset_version=OPSET, do_constant_folding=True, input_names=list(INPUT_NAMES),
                              output_names=list(OUTPUT_NAMES),
                              dynamic_axes={n: {0: BATCH_AXIS} for n in INPUT_NAMES + OUTPUT_NAMES},
                              dynamo=False)
        check_contract(read_onnx_summary(tmp))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, path)
    return path


def read_onnx_summary(path: str) -> dict:
    """An ONNX file's structure, read without the ``onnx`` package:
    ``{ir_version, opset, inputs, outputs, dims, initializers, op_counts,
    total_weight_floats}``; ``dims`` maps each graph input and output to its
    dims (a value, a dynamic axis's name, or None). Raises ``ValueError`` on
    a file that is not a ModelProto."""
    g = load_onnx_graph(path)
    return {
        "ir_version": g.ir_version, "opset": g.opset, "inputs": g.inputs, "outputs": g.outputs,
        "dims": {n: g.dims.get(n) for n in g.inputs + g.outputs}, "initializers": len(g.initializers),
        "op_counts": g.op_counts(), "total_weight_floats": int(sum(a.size for a in g.initializers.values())),
    }


def check_contract(summary: dict) -> None:
    """Raise ``ValueError`` unless ``summary`` has the deployment contract:
    the names, opset 17, initializers, and the dynamic batch axis on all
    six tensors."""
    dims = summary["dims"]
    broken = {
        "opset": summary["opset"] != OPSET,
        "inputs": summary["inputs"] != INPUT_NAMES,
        "outputs": summary["outputs"] != OUTPUT_NAMES,
        "initializers": summary["initializers"] == 0,
        "dims": not all(d and d[0] == BATCH_AXIS and len(d) == 4 for d in dims.values()),
    }
    if any(broken.values()):
        raise ValueError(f"not the deployment contract ({', '.join(k for k, v in broken.items() if v)}): "
                         f"{ {k: summary[k] for k in ('opset', 'inputs', 'outputs', 'initializers', 'dims')} }")


def selftest_frames(height: int, width: int, batch: int = 1, seed: int = 0):
    """NCHW float32 (rgb, depth) of the JAX selftest: random RGB and a
    smooth depth under a 6% mask, so that small frames still give nonzero
    outputs inside the border mask."""
    rng = np.random.default_rng(seed)
    rgb = (rng.random((batch, 3, height, width)) * 255).astype(np.float32)
    truth = np.fromfunction(lambda n, c, i, j: 5 + 3 * np.sin(i / 9) + 2 * np.cos(j / 11),
                            (batch, 1, height, width)).astype(np.float32)
    dep = (truth * (rng.random((batch, 1, height, width)) < 0.06)).astype(np.float32)
    return rgb, dep


def selftest_guided_onnx(path: str, model_or_state=None, *, height: int = 480, width: int = 640,
                         kernel_mode: str = "softplus", rel_tol: float = 1e-4) -> dict:
    """Validate a deployment ONNX file.

    Always checks the structure (a ModelProto with the contract,
    :func:`check_contract`; ``ValueError`` otherwise). Given ``model_or_state``, also executes the
    file on :func:`selftest_frames` with :func:`.onnx_exec.run_onnx` and
    holds it to the port's plain path on the same weights: relative RMSE
    below ``rel_tol`` on each stream. Returns the summary with
    ``exec_rel_rmse`` (None when nothing was executed); raises
    ``AssertionError`` over the bar."""
    summary = read_onnx_summary(path)
    check_contract(summary)
    summary["exec_rel_rmse"] = None
    if model_or_state is None:
        return summary
    rgb, dep = selftest_frames(height, width)
    feeds = {"rgb_0": rgb, "depth_0": dep, "rgb_1": rgb, "depth_1": dep}
    got = run_onnx(path, feeds)
    with torch.no_grad():
        want = _Nchw(positive_cpu_model(model_or_state, kernel_mode))(
            *(torch.from_numpy(feeds[n]) for n in INPUT_NAMES))
    rel = max(float(np.linalg.norm(np.float64(g) - w.double().numpy())
                    / max(float(w.double().norm()), 1e-30)) for g, w in zip(got, want))
    summary["exec_rel_rmse"] = rel
    if not rel < rel_tol:
        raise AssertionError(f"executed ONNX outputs diverge: rel RMSE {rel}")
    return summary
