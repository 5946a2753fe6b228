"""The host data path in C (``csrc/host/depthio.cpp``), bound with ctypes:
the PNG row unfilter that :func:`.png.decode` runs, the sample conversions
of the PNG readers that :mod:`.io` runs, the crop and mask of the datasets
(:func:`.datasets.crop_top_center`, :func:`.sparsify.apply_mask_pool`) and
the streaming engine's wire encoders (the JAX package's ``data/native.py``).

The source is compiled at first use with the host compiler (``$CXX``, else
``g++``) into ``build/nconv_tpu_torch/`` beside the package; the library's
name carries a hash of the source and flags, so an edit rebuilds it. It
links nothing but the C++ runtime: inflate stays in Python's ``zlib``, and
the C side does what is slow in Python, the row filters and the sample
conversions. There is no fallback: a failed build raises, and so does every
reader and encoder after it. ctypes releases the GIL around each call, so a
thread pool decodes in parallel. :func:`encode_frame_dense` is parallel
inside the library: one call encodes both streams' dense wire in row bands
on a pool of C++ threads kept for the life of the process, as many as
:func:`encode_threads` reads from the process's CPU affinity. Its workers
sleep between frames and are never joined (a process exits at once); a
forked child builds a pool of its own at its first call.

The plain versions stay beside it, for the tests: :func:`.png._unfilter`,
:meth:`.png.PNG.array` and :meth:`.png.PNG.rgb`, and ``runtime/wires.py``.
The readers, the crop, the mask and the depth and COO encoders are bitwise
those; the YUV encoders round in integers, bitwise the JAX package's C
encoders and within one step of ``wires.py``'s float forms. The JAX
package's wire readers (``load_depth_wire_u16``, ``load_rgb_wire_u8``) and
``png_info`` have no counterpart: nothing in either package calls them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "depthio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "nconv_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I, _L, _F = ctypes.c_int, ctypes.c_long, ctypes.c_float
_SIGNATURES = {  # name: (argtypes, restype)
    "nct_png_unfilter": ([_u8, _I, _L, _I, _u8], _I),
    "nct_depth_f32": ([_u8, _L, _I, _F, _f32], None),
    "nct_rgb": ([_u8, _L, _I, _I, _u8, _I, _I, _f32], _I),
    "nct_crop_top_center": ([_f32, _I, _I, _I, _I, _I, _f32], None),
    "nct_apply_mask": ([_f32, _f32, _L], None),
    "nct_encode_depth_wire": ([_f32, _u16, _L, _F], None),
    "nct_encode_frame_dense": ([_u8, _f32, _u8, _f32, _u8, _u16, _u8, _u16, _I, _I, _F, _I, _I], _I),
    "nct_encode_depth_coo": ([_f32, _L, _L, _F, _i32, _u16], _L),
    "nct_encode_yuv420": ([_u8, _I, _I, _u8, _u8, _u8], None),
    "nct_encode_yuv422": ([_u8, _I, _I, _u8, _u8, _u8], None),
}


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the host library if this source has none yet; returns its
    path. Raises ``RuntimeError`` when the compiler is missing or fails."""
    so = BUILD_DIR / f"libnct_depthio_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or "g++"
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host compiler {cxx!r} for {SOURCE.name} not runnable: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"host compiler {cxx!r} failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build sees a whole file
    return so


def lib() -> ctypes.CDLL:
    """The loaded host library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = cdll
    return _lib


def _out(out, shape, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype)
    if out.shape != tuple(shape) or out.dtype != dtype or not out.flags.c_contiguous:
        raise ValueError(f"out {out.shape} {out.dtype} != contiguous {tuple(shape)} {np.dtype(dtype)}")
    return out


# -- PNG ------------------------------------------------------------------------

def unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, stride) uint8 rows from a PNG's decompressed image data
    (each row a filter byte, then ``stride`` filtered bytes); bitwise
    :func:`.png._unfilter`."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, {height * (stride + 1)} expected")
    out = np.empty((height, stride), np.uint8)
    bad = lib().nct_png_unfilter(raw, height, stride, bpp, out)
    if bad:
        y = bad - 1
        raise ValueError(f"PNG row {y} has filter type {raw[y * (stride + 1)]} (0-4 exist)")
    return out


def _rows(path: str):
    from . import png

    with open(path, "rb") as f:
        return png.parse(f.read())


def load_depth_png16(path: str, scale: float = 256.0) -> np.ndarray:
    """(H, W) float32 depth of a greyscale PNG, sample / ``scale``."""
    width, height, depth, ctype, _, rows = _rows(path)
    if ctype != 0:
        raise ValueError(f"{path}: depth PNGs are greyscale, not colour type {ctype}")
    out = np.empty((height, width), np.float32)
    lib().nct_depth_f32(rows, out.size, depth, scale, out)
    return out


def load_rgb(path: str, *, bgr: bool = True) -> np.ndarray:
    """(H, W, 3) float32, 0..255, BGR by default: PIL's ``convert("RGB")``
    of any type that :func:`.png.parse` reads."""
    width, height, depth, ctype, palette, rows = _rows(path)
    out = np.empty((height, width, 3), np.float32)
    pal = np.zeros((0, 3), np.uint8) if palette is None else np.ascontiguousarray(palette)
    if lib().nct_rgb(rows, height * width, ctype, depth, pal, len(pal), int(bgr), out):
        raise ValueError(f"{path}: colour type {ctype} at {depth} bits")
    return out


def crop_top_center(arr: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """The bottom ``oh`` rows and centred ``ow`` columns of an (H, W) or
    (H, W, C) array, as float32."""
    a = np.ascontiguousarray(arr, np.float32)
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]
    if not (0 < oh <= h and 0 < ow <= w):
        raise ValueError(f"crop {oh}x{ow} of a {h}x{w} array")
    out = np.empty((oh, ow) + a.shape[2:], np.float32)
    lib().nct_crop_top_center(a, h, w, c, oh, ow, out)
    return out


def apply_mask(depth: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``depth * mask`` in a fresh float32 array; the caller's ``depth`` is
    never written."""
    d = np.array(depth, np.float32, copy=True, order="C")
    m = np.ascontiguousarray(mask, np.float32)
    if m.shape != d.shape:
        raise ValueError(f"mask {m.shape} != depth {d.shape}")
    lib().nct_apply_mask(d, m, d.size)
    return d


# -- wire encoders --------------------------------------------------------------

def encode_depth_wire(depth: np.ndarray, scale: float = 256.0, out: np.ndarray | None = None) -> np.ndarray:
    """float depth (meters) -> uint16 wire ``clip(d * scale, 0, 65535)``
    truncated, of ``depth``'s shape."""
    d = np.ascontiguousarray(depth, np.float32)
    out = _out(out, d.shape, np.uint16)
    lib().nct_encode_depth_wire(d, out, d.size, scale)
    return out


ENCODE_THREADS = 4  # most threads on one frame (the thread scan in PERF.md)
BAND_ROWS = 16  # rows of a band: a thread that wakes late takes fewer


def encode_threads() -> int:
    """Threads that :func:`encode_frame_dense` runs a frame on, the caller's
    included: one less than the CPUs the process may run on, at most
    :data:`ENCODE_THREADS`, at least 1 (the caller alone)."""
    return max(1, min(ENCODE_THREADS, len(os.sched_getaffinity(0)) - 1))


def _frame_part(a: np.ndarray, size: int, dtype, what: str) -> np.ndarray:
    if a.dtype != dtype or a.size != size or not a.flags.c_contiguous:
        raise ValueError(f"{what} {a.shape} {a.dtype} != contiguous {size} x {np.dtype(dtype)}")
    return a


def encode_frame_dense(rgb0: np.ndarray, depth0: np.ndarray, rgb1: np.ndarray, depth1: np.ndarray,
                       out: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray], scale: float = 256.0,
                       threads: int | None = None, bands: int | None = None) -> tuple[np.ndarray, ...]:
    """Both streams' dense wire in one call, into ``out`` = (RGB 0, depth 0,
    RGB 1, depth 1): each (..., H, W, 3) uint8 RGB frame copied, each float
    depth of H x W pixels encoded as :func:`encode_depth_wire`, bitwise the
    two per stream. Each stream is cut into ``bands`` row bands (default
    :data:`BAND_ROWS` rows each), taken as they come free by the calling
    thread and ``threads - 1`` threads of the library's pool (default
    :func:`encode_threads`). Returns ``out``."""
    rgb = [np.ascontiguousarray(rgb0), np.ascontiguousarray(rgb1)]
    h, w = rgb[0].shape[-3:-1] if rgb[0].ndim >= 3 else (0, 0)
    for a in rgb:
        _frame_part(a, 3 * h * w, np.uint8, "rgb")
        if a.shape[-1] != 3:
            raise ValueError(f"rgb {a.shape} is not (..., H, W, 3)")
    depth = [_frame_part(np.ascontiguousarray(d, np.float32), h * w, np.float32, "depth") for d in (depth0, depth1)]
    for a, dt in zip(out, (np.uint8, np.uint16) * 2):
        _frame_part(a, (3 if dt == np.uint8 else 1) * h * w, dt, "out")
    threads = encode_threads() if threads is None else threads
    bands = max(1, -(-h // BAND_ROWS)) if bands is None else bands
    if lib().nct_encode_frame_dense(rgb[0], depth[0], rgb[1], depth[1], *out, h, w, scale, bands, threads):
        raise ValueError(f"bands {bands} (at least 1), threads {threads} (1-64)")
    return out


def encode_depth_coo(depth: np.ndarray, capacity: int, scale: float = 256.0,
                     out: tuple[np.ndarray, np.ndarray] | None = None) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns ``(idx, val, n_nonzero)``: ``idx`` (1, capacity) int32 flat
    indices and ``val`` (1, capacity) uint16 values of the first
    ``capacity`` nonzero points in row-major order, the rest zero;
    ``n_nonzero`` counts every nonzero point (over ``capacity``: dropped)."""
    d = np.ascontiguousarray(depth, np.float32)
    idx, val = (None, None) if out is None else out
    idx = _out(idx, (1, capacity), np.int32)
    val = _out(val, (1, capacity), np.uint16)
    n = lib().nct_encode_depth_coo(d, d.size, capacity, scale, idx, val)
    return idx, val, int(n)


def _yuv(name, rgb, out, chroma_shape):
    a = np.ascontiguousarray(rgb, np.uint8)
    h, w = a.shape[:2]
    if a.shape != (h, w, 3):
        raise ValueError(f"{name} takes (H, W, 3) uint8 RGB, not {a.shape}")
    y, u, v = (None,) * 3 if out is None else out
    y, u, v = _out(y, (h, w), np.uint8), _out(u, chroma_shape(h, w), np.uint8), _out(v, chroma_shape(h, w), np.uint8)
    getattr(lib(), "nct_encode_" + name)(a, h, w, y, u, v)
    return y, u, v


def encode_yuv420(rgb: np.ndarray, out: tuple[np.ndarray, ...] | None = None):
    """HWC uint8 RGB -> (y (h, w), u (h/2, w/2), v (h/2, w/2)), uint8,
    BT.601 full range, chroma of 2x2 block means; h and w even."""
    h, w = rgb.shape[:2]
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 needs an even height and width; got {h}x{w}")
    return _yuv("yuv420", rgb, out, lambda h, w: (h // 2, w // 2))


def encode_yuv422(rgb: np.ndarray, out: tuple[np.ndarray, ...] | None = None):
    """HWC uint8 RGB -> (y (h, w), u (h, w/2), v (h, w/2)), uint8, chroma
    sampled at the even columns; w even."""
    w = rgb.shape[1]
    if w % 2:
        raise ValueError(f"yuv422 needs an even width; got {w}")
    return _yuv("yuv422", rgb, out, lambda h, w: (h, w // 2))
