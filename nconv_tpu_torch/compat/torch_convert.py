"""Reference (PyTorch) checkpoints to the port's state dicts, and back.

The reference models (``SETP1_NCONV``; ``SETP2_BP_TRAIN`` / ``SETP2_BP_EXPORT``)
and the port are both torch with OIHW kernels, so conversion renames keys
and moves no axis:

  * ``module.`` DataParallel prefixes are stripped (the reference always
    saves DataParallel-wrapped models);
  * dead state is dropped: per-NConv ``bnorm.*`` (never used in forward),
    ``rgb_encoder4.*`` (registered, never called), ``num_batches_tracked``;
  * the RGB encoders' ``encoder.0`` / ``encoder.1`` / ``downsample.0`` are
    the port's ``conv`` / ``bn`` / ``shortcut``; a head ``fuseN.conv`` is
    ``fuseN.conv.conv``; the transpose conv ``upcat.upf.conv`` is
    ``upcat.upf.conv_t``; ``upcat.conv.conv.{conv,bn}`` is
    ``upcat.conv.{conv,bn}``; step 1's ``d_net`` is the port's
    ``NConvUNet`` itself;
  * NConv kernels: a reference checkpoint holds them positive (its
    EnforcePos hook rewrites the stored weight during training, and its eval
    applies no transform). ``kernel_mode='raw'`` keeps them so (build the
    model with ``pos_fn='identity'``); ``'softplus_inverse'`` stores their
    inverse softplus (beta 10) for the default ``pos_fn='softplus'``
    models. Back to the reference, ``'softplus'`` writes the effective
    positive kernels of a softplus model and ``'raw'`` copies them.

The reverse direction expects unfolded state (BN statistics present). The
functions work on torch or numpy values; the forward direction returns CPU
float32 tensors, the reverse numpy arrays.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "convert_guided_state_dict",
    "convert_unguided_state_dict",
    "load_pth_tar",
    "save_pth_tar",
    "softplus10_inverse",
    "strip_data_parallel_prefix",
    "to_guided_state_dict",
    "to_unguided_state_dict",
]

_SKIP = re.compile(r"(\.bnorm\.)|(^rgb_encoder4\.)|(num_batches_tracked$)")

# (reference key, port key) templates; each {field} is one of _FIELDS
_FIELDS = {
    "n": r"nconv(?:_down)?\d", "e": r"rgb_encoder\d", "f": r"fuse\d",
    "c": r"rgb_conv|depth_conv|fuse_conv\d", "p": r"weight|bias", "s": r"weight|bias|running_mean|running_var",
}
_GUIDED = [
    ("step1.d_net.{n}.{p}", "step1.{n}.{p}"),
    ("{e}.encoder.0.{p}", "{e}.conv.{p}"),
    ("{e}.encoder.1.{s}", "{e}.bn.{s}"),
    ("{e}.downsample.0.weight", "{e}.shortcut.weight"),
    ("{f}.fuse.{c}.conv.{p}", "{f}.fuse.{c}.conv.{p}"),
    ("{f}.conv.weight", "{f}.conv.conv.weight"),
    ("{f}.upcat.upf.conv.weight", "{f}.upcat.upf.conv_t.weight"),
    ("{f}.upcat.upf.bn.{s}", "{f}.upcat.upf.bn.{s}"),
    ("{f}.upcat.conv.conv.conv.weight", "{f}.upcat.conv.conv.weight"),
    ("{f}.upcat.conv.conv.bn.{s}", "{f}.upcat.conv.bn.{s}"),
]
_UNGUIDED = [("d_net.{n}.{p}", "{n}.{p}")]


def _pattern(template: str) -> re.Pattern:
    return re.compile(re.sub(r"\\\{(\w)\\\}", lambda m: f"(?P<{m[1]}>{_FIELDS[m[1]]})", re.escape(template)))


def _rename(key: str, table, what: str, *, to_port: bool) -> str:
    for ref, port in table:
        src, dst = (ref, port) if to_port else (port, ref)
        m = _pattern(src).fullmatch(key)
        if m:
            return dst.format(**m.groupdict())
    raise KeyError(f"unrecognized {what} key: {key}")


_NCONV_WEIGHT = re.compile(r"(^|\.)nconv(?:_down)?\d\.weight$")


def strip_data_parallel_prefix(sd: Mapping[str, Any]) -> dict[str, Any]:
    return {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def softplus10_inverse(y: np.ndarray) -> np.ndarray:
    """Stable inverse of softplus (beta 10), in float64, returned in ``y``'s
    dtype: positive reference weights stored as raw parameters."""
    z = 10.0 * np.asarray(y, np.float64)
    # log(expm1(z)) = z + log1p(-exp(-z)), stable for large z
    out = np.where(z < 20.0, np.log(np.expm1(np.clip(z, 1e-30, 20.0))),
                   z + np.log1p(-np.exp(-np.clip(z, 20.0, None))))
    return (out / 10.0).astype(np.asarray(y).dtype)


def _softplus10(w: np.ndarray) -> np.ndarray:
    """softplus (beta 10) in float64, returned in ``w``'s dtype."""
    return (np.logaddexp(0.0, 10.0 * np.asarray(w, np.float64)) / 10.0).astype(w.dtype)


def _convert(sd, table, what, kernel_mode) -> dict[str, torch.Tensor]:
    if kernel_mode not in ("raw", "softplus_inverse"):
        raise ValueError(f"unknown kernel_mode {kernel_mode!r}")
    out = {}
    for key, v in strip_data_parallel_prefix(sd).items():
        if _SKIP.search(key):
            continue
        name, a = _rename(key, table, what, to_port=True), _np(v)
        if kernel_mode == "softplus_inverse" and _NCONV_WEIGHT.search(name):
            a = softplus10_inverse(a)
        out[name] = torch.from_numpy(np.array(a, np.float32))
    return out


def convert_unguided_state_dict(sd: Mapping[str, Any], *, kernel_mode: str = "raw") -> dict[str, torch.Tensor]:
    """``SETP1_NCONV`` state dict -> the port's ``NConvUNet`` state dict."""
    return _convert(sd, _UNGUIDED, "step-1", kernel_mode)


def convert_guided_state_dict(sd: Mapping[str, Any], *, kernel_mode: str = "raw") -> dict[str, torch.Tensor]:
    """``SETP2_BP_*`` state dict -> the port's unfolded ``GuidedDepthNet``
    state dict."""
    return _convert(sd, _GUIDED, "step-2", kernel_mode)


def _to_reference(state, table, what, kernel_mode) -> dict[str, np.ndarray]:
    if kernel_mode not in ("softplus", "raw"):
        raise ValueError(f"unknown kernel_mode {kernel_mode!r}")
    out = {}
    for key, v in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        a = _np(v)
        if kernel_mode == "softplus" and _NCONV_WEIGHT.search(key):
            a = _softplus10(a)
        out[_rename(key, table, what, to_port=False)] = a
    return out


def to_unguided_state_dict(state: Mapping[str, Any], *, kernel_mode: str = "softplus") -> dict[str, np.ndarray]:
    """The port's ``NConvUNet`` state dict -> a ``SETP1_NCONV`` state dict.
    ``'softplus'`` (default) writes the effective positive kernels of a
    ``pos_fn='softplus'`` model; ``'raw'`` copies the kernels of one
    converted with ``kernel_mode='raw'`` (already positive)."""
    return _to_reference(state, _UNGUIDED, "unguided", kernel_mode)


def to_guided_state_dict(state: Mapping[str, Any], *, kernel_mode: str = "softplus") -> dict[str, np.ndarray]:
    """The port's unfolded ``GuidedDepthNet`` state dict -> a
    ``SETP2_BP_EXPORT``-loadable state dict (it also loads into
    ``SETP2_BP_TRAIN`` under ``strict=False``, as every reference load site
    loads, its dead state left at init)."""
    if not any(k.endswith(".bn.running_mean") for k in state):
        raise ValueError("to_guided_state_dict takes an unfolded state dict (BN folded has no BN state)")
    return _to_reference(state, _GUIDED, "guided", kernel_mode)


def save_pth_tar(path, state: Mapping[str, Any], *, model: str = "guided", kernel_mode: str = "softplus",
                 epoch: int = 0, stats=None) -> str:
    """Write a port state dict as a reference ``.pth.tar``
    (``{'epoch', 'state_dict', 'stats'}``, keys with DataParallel
    ``module.`` prefixes), ready for the reference's ONNX export or
    training."""
    to_sd = to_guided_state_dict if model == "guided" else to_unguided_state_dict
    sd = {"module." + k: torch.from_numpy(np.array(v, np.float32))
          for k, v in to_sd(state, kernel_mode=kernel_mode).items()}
    torch.save({"epoch": epoch, "state_dict": sd, "stats": stats}, path)
    return str(path)


def load_pth_tar(path) -> dict[str, np.ndarray]:
    """A reference ``.pth.tar`` (``{'state_dict': ...}`` or a bare state
    dict) as a numpy state dict. Loads with ``weights_only=True``: the
    format holds tensors and plain values only, and a file that pickles
    any other object is refused rather than run."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=True)
    sd = checkpoint.get("state_dict", checkpoint)
    return {k: _np(v) for k, v in sd.items()}
