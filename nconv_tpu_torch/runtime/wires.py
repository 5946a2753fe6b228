"""Host-side wire encoders of the streaming engine, in numpy.

Each is bitwise the numpy form of ``nconv_tpu/data/native.py``'s encoder
of the same name (the port keeps its own copy: it imports nothing of the
JAX package). The depth encoders are bitwise the C encoders of ``native/``
too; the C YUV encoders round in integers and may differ by one step. Each
takes an ``out=`` buffer, so that the engine encodes straight into a pinned
staging slot.

  * dense depth: ``uint16 = clip(d * scale, 0, 65535)`` truncated, the
    KITTI 16-bit PNG encoding;
  * COO depth: the first ``capacity`` nonzero points as (flat index int32,
    the same uint16 value), padding (0, 0); the count of all nonzero points
    comes back, so that a caller can count what was dropped;
  * YUV 4:2:0 and 4:2:2: BT.601 full range, luma per pixel; chroma from
    2x2 block means (4:2:0) or co-sited at even columns (4:2:2).
"""
from __future__ import annotations

import numpy as np


def _out(out, shape, dtype):
    if out is None:
        return np.empty(shape, dtype)
    if out.shape != tuple(shape) or out.dtype != dtype:
        raise ValueError(f"out {out.shape} {out.dtype} != {tuple(shape)} {np.dtype(dtype)}")
    return out


def encode_depth_wire(depth: np.ndarray, scale: float = 256.0, out: np.ndarray | None = None) -> np.ndarray:
    """float depth (meters) -> uint16 wire of ``depth``'s shape."""
    d = np.ascontiguousarray(depth, np.float32)
    out = _out(out, d.shape, np.uint16)
    out[...] = np.clip(d * scale, 0, 65535).astype(np.uint16)
    return out


def encode_depth_coo(depth: np.ndarray, capacity: int, scale: float = 256.0,
                     out: tuple[np.ndarray, np.ndarray] | None = None) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns ``(idx, val, n_nonzero)``: ``idx`` (1, capacity) int32 flat
    indices and ``val`` (1, capacity) uint16 values of the first
    ``capacity`` nonzero points in row-major order, the rest zero;
    ``n_nonzero`` counts every nonzero point (over ``capacity``: dropped)."""
    flat = np.ascontiguousarray(depth, np.float32).ravel()
    idx, val = (None, None) if out is None else out
    idx = _out(idx, (1, capacity), np.int32)
    val = _out(val, (1, capacity), np.uint16)
    nz = np.flatnonzero(flat)
    keep = nz[:capacity]
    idx[0, : keep.size] = keep
    idx[0, keep.size:] = 0
    # clip in float, then narrow to u16: the C encoder's truncation
    val[0, : keep.size] = np.clip(flat[keep] * scale, 0, 65535).astype(np.uint16)
    val[0, keep.size:] = 0
    return idx, val, int(nz.size)


def _luma_chroma(rgb, y, u, v, chroma):
    """Luma of every pixel into ``y``; ``chroma(plane)`` subsamples one of
    r, g, b, and U, V of the subsampled planes go into ``u``, ``v``."""
    f = np.ascontiguousarray(rgb, np.uint8).astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    # luma into its own buffer: r, g, b are views of f
    y[:] = np.clip(0.299 * r + 0.587 * g + 0.114 * b + 0.5, 0, 255).astype(np.uint8)
    rm, gm, bm = chroma(r), chroma(g), chroma(b)
    u[:] = np.clip(-0.168736 * rm - 0.331264 * gm + 0.5 * bm + 128.5, 0, 255).astype(np.uint8)
    v[:] = np.clip(0.5 * rm - 0.418688 * gm - 0.081312 * bm + 128.5, 0, 255).astype(np.uint8)
    return y, u, v


def encode_yuv420(rgb: np.ndarray, out: tuple[np.ndarray, ...] | None = None):
    """HWC uint8 RGB -> (y (h, w), u (h/2, w/2), v (h/2, w/2)), uint8;
    h and w even."""
    h, w = rgb.shape[:2]
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 needs an even height and width; got {h}x{w}")
    y, u, v = (None,) * 3 if out is None else out
    y, u, v = _out(y, (h, w), np.uint8), _out(u, (h // 2, w // 2), np.uint8), _out(v, (h // 2, w // 2), np.uint8)
    # 2x2 block means: four uint8 values sum exactly in float32, so this is
    # bitwise the numpy form's mean over (2, 2) blocks, at a fraction of its cost
    return _luma_chroma(rgb, y, u, v, lambda c: (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]) / 4)


def encode_yuv422(rgb: np.ndarray, out: tuple[np.ndarray, ...] | None = None):
    """HWC uint8 RGB -> (y (h, w), u (h, w/2), v (h, w/2)), uint8, chroma
    sampled at the even columns; w even."""
    h, w = rgb.shape[:2]
    if w % 2:
        raise ValueError(f"yuv422 needs an even width; got {w}")
    y, u, v = (None,) * 3 if out is None else out
    y, u, v = _out(y, (h, w), np.uint8), _out(u, (h, w // 2), np.uint8), _out(v, (h, w // 2), np.uint8)
    return _luma_chroma(rgb, y, u, v, lambda c: c[:, 0::2])
