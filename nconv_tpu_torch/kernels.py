"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, all started together, then one
link) into a shared library with a plain C interface under
``build/nconv_tpu_torch/`` beside the package, and bound with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an edit
rebuilds it. Nothing here runs at import time.

Every kernel wrapper launches through :func:`launch`, which makes the
tensors' device current for the call (the launch, a kernel's shared-memory
attribute and its occupancy query all act on the current device) and adds
one to the kernel's entry of :data:`LAUNCHES`, and nowhere else, so a
caller can show which kernels a run went through
(:func:`reset_launch_counts`, :func:`launch_counts`).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "nconv_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

# launches per kernel, counted by the wrappers in ops/
LAUNCHES: dict[str, int] = {
    "nconv": 0, "conv": 0, "conv_tc": 0, "conv_thin": 0, "conv_transpose": 0, "conv_transpose_tc": 0,
    "conv_chain": 0, "conv_chain_tc": 0,
    "conv_kxk": 0, "conv_input_grad_tc": 0, "filtergrad": 0,
    "conv4x4s2": 0, "conv4x4s2_tc": 0, "conv_transpose3x3s2": 0, "conv_transpose3x3s2_tc": 0, "wgrad": 0,
    "wgrad_tc": 0,
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: argtypes (all return int: cudaGetLastError(), or for
    # nct_filtergrad_slices / nct_wgrad_slices / nct_wgrad_tc_slices the row
    # count of K5's / K6's partial-sum buffer)
    "nct_conv3x3": [P, P, I, I, I, I, I, I, I, I, I, I, I, P, P, P, P, I, P],
    "nct_nconv": [P, P, P, I, I, I, I, I, I, I, I, I, I, F, P, P, P, P, P, P, P, P],
    "nct_conv_transpose4x4s2": [P, P, I, I, I, I, I, I, I, P, P, P, I, P],
    "nct_conv_tc": [P, P, I, I, I, I, I, I, I, P, I, I, P, P, I, P, I, I, P],
    "nct_conv_thin": [P, P, I, I, I, I, I, I, I, P, P, P, I, P, I, P],
    "nct_conv_chain2": [P, I, I, I, I, I, I, I, P, P, P, P, P, P],
    "nct_conv_chain_tc": [P, I, I, I, I, I, I, P, P, P, P, I, P, P],
    "nct_conv_kxk": [P, P, I, I, I, I, I, I, I, I, I, I, I, P, P, P],
    "nct_filtergrad": [P, P, I, I, I, I, I, I, I, I, I, I, P, P, P],
    "nct_filtergrad_slices": [I, I, I, I, I, I, I],
    "nct_conv_transpose3x3s2": [P, P, I, I, I, I, I, I, P, P, P],
    "nct_wgrad": [P, P, I, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P, P, P],
    "nct_wgrad_slices": [I, I, I, I, I],
    "nct_wgrad_tc": [P, P, I, P, P, I, I, I, I, I, I, I, I, I, I, I, P, P, P],
    "nct_wgrad_tc_slices": [I, I, I, I, I, I, I],
}

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):  # what nvcc reads, not host_emu.h
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source tree has no library yet, inside
    a ``kernels.build`` span of :mod:`.runtime.tracing`; returns the
    library's path."""
    so = BUILD_DIR / f"libnconv_tpu_torch_{_digest()}.so"
    if so.exists():
        return so
    from .runtime import tracing

    with tracing.span("kernels.build"):
        _compile(so)
    return so


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build sees a whole file
    for obj in objs:
        obj.unlink(missing_ok=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            cdll.nct_error_string.argtypes = [ctypes.c_int]
            cdll.nct_error_string.restype = ctypes.c_char_p
            _lib = cdll
    return _lib


def on_card(*tensors: torch.Tensor | None) -> bool:
    """True when every given tensor is on a CUDA device (the kernel path),
    False when every one is on the CPU (the plain path); raises otherwise."""
    types = {t.device.type for t in tensors if t is not None}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(types)}")


def no_graph(what: str, *tensors: torch.Tensor | None) -> None:
    """Raise where a kernel would silently drop the autograd graph: the
    kernels record none, so with grad enabled no input may require grad
    (the training forward reaches K1 inside an autograd Function, whose
    forward runs with grad disabled)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel records no autograd graph; call it under "
            "torch.no_grad() or through its autograd Function"
        )


@contextlib.contextmanager
def exact_f32(t: torch.Tensor):
    """Full-f32 convolutions and matmuls (no TF32) while a plain version
    runs on the card; a no-op for CPU tensors."""
    if t.device.type != "cuda":
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or as it is if float64: the plain versions compute
    in at least f32, and in f64 they give a reference for the f32 paths."""
    return t if t.dtype == torch.float64 else t.float()


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value (read
    without building a ``torch.cuda.Stream``, a few microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


class device_guard:
    """``t``'s CUDA device made current while entered, the previous one
    after (``torch.cuda.device``'s switch, without its argument parsing: a
    guard wraps every launch)."""

    __slots__ = ("idx", "prev")

    def __init__(self, t: torch.Tensor):
        self.idx = t.device.index

    def __enter__(self):
        self.prev = torch.cuda._exchange_device(self.idx)

    def __exit__(self, *exc):
        torch.cuda._maybe_exchange_device(self.prev)
        return False


def launch(counter: str, entry: str, on: torch.Tensor, *args) -> None:
    """Call the library's launcher ``entry(*args, stream)``, each tensor in
    ``args`` passed as its data pointer, inside :func:`device_guard` of
    ``on`` (a tensor the kernel writes) and on the current stream of ``on``'s
    device; raise on a CUDA error, else count one launch of ``counter``."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    fn = getattr(_lib or lib(), entry)
    with device_guard(on):
        code = fn(*args, stream_of(on))
    if code:
        raise RuntimeError(f"{counter} kernel: CUDA error {code} ({lib().nct_error_string(code).decode()})")
    LAUNCHES[counter] += 1


def part_args(parts: list[torch.Tensor], up2: list[bool]):
    """ctypes arrays for a list of NCHW-indexed parts (any strides)."""
    n = len(parts)
    ptrs = (ctypes.c_void_p * n)(*[p.data_ptr() for p in parts])
    meta = []
    for p, u in zip(parts, up2):
        meta += [p.shape[1], int(u), *p.stride()]
    return ptrs, (ctypes.c_longlong * len(meta))(*meta)
