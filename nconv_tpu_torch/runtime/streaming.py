"""Streaming inference engine: two camera streams at batch 1.

  host frames (HWC uint8 RGB, HW float sparse depth)
    -> wire encode on the host: RGB stays uint8, depth becomes uint16
       fixed point clip(d * 256, 0, 65535) truncated (the KITTI PNG encoding)
    -> copy to the device
    -> decode: depth / 256 in f32; RGB enters the first conv as uint8 and
       is decoded there (raw 0..255 values)
    -> GuidedDepthNet.export with BatchNorm folded
    -> border-masked dense depth per stream

Dense wires only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch

from ..models import GuidedDepthNet, maybe_fold, resolve_device


@dataclass
class FrameStats:
    fps: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    mean_ms: float
    n_frames: int
    clock: str  # "cuda_events" or "host"


def encode_depth_wire(depth: np.ndarray, scale: float = 256.0) -> np.ndarray:
    """float depth (meters) -> uint16 wire: clip(d * scale, 0, 65535), truncated."""
    d = np.asarray(depth, np.float32) * np.float32(scale)
    return np.clip(d, 0, 65535).astype(np.uint16)


class StreamingEngine:
    """``engine(rgb0, d0, rgb1, d1)`` takes host numpy frames and returns
    the two dense depth maps ``(1, H, W, 1)`` on the engine's device.

    ``state_dict`` holds the port's (unfolded or folded) weights, e.g. from
    :func:`nconv_tpu_torch.convert.from_jax_variables`; BatchNorm is folded
    on construction. ``compute_dtype=torch.bfloat16`` runs the mixed
    schedule (bf16 feature convs, f32 step 1 and depth path).
    """

    DEPTH_SCALE = 256.0

    def __init__(
        self,
        state_dict: Mapping[str, torch.Tensor],
        *,
        height: int,
        width: int,
        compute_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.device = resolve_device(device)
        model = GuidedDepthNet(dtype=compute_dtype, device=self.device)
        self.model, state = maybe_fold(model, state_dict)
        self.model.load_state_dict({k: v.to(self.device) for k, v in state.items()})
        self.model.eval()
        self.height, self.width = height, width

    @property
    def wire_bytes_per_frame(self) -> int:
        """Host->device bytes per two-stream frame (u8 RGB + u16 depth)."""
        return 2 * self.height * self.width * (3 + 2)

    def _stage(self, arr: np.ndarray, channels: int) -> torch.Tensor:
        a = np.asarray(arr)
        if channels == 3:
            if a.dtype != np.uint8:
                a = np.clip(a, 0, 255).astype(np.uint8)
        elif a.dtype != np.uint16:
            a = encode_depth_wire(a, self.DEPTH_SCALE)
        if a.ndim == 2:
            a = a[:, :, None]
        if a.ndim == 3:
            a = a[None]
        if a.shape != (1, self.height, self.width, channels):
            raise ValueError(f"frame {a.shape} != {(1, self.height, self.width, channels)}")
        if a.dtype == np.uint16:
            a = a.view(np.int16)  # torch moves int16 everywhere; decoded below
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _decode_depth(self, wire: torch.Tensor) -> torch.Tensor:
        return (wire.to(torch.int32) & 0xFFFF).to(torch.float32) / self.DEPTH_SCALE

    def __call__(self, rgb0, depth0, rgb1, depth1):
        return self.model.export(
            self._stage(rgb0, 3), self._decode_depth(self._stage(depth0, 1)),
            self._stage(rgb1, 3), self._decode_depth(self._stage(depth1, 1)),
        )

    def warmup(self) -> None:
        z = np.zeros((self.height, self.width), np.float32)
        r = np.zeros((self.height, self.width, 3), np.uint8)
        self(r, z, r, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _stats(lat_s: np.ndarray, clock: str) -> FrameStats:
    ms = lat_s * 1e3
    return FrameStats(
        fps=float(1.0 / lat_s.mean()),
        p50_ms=float(np.percentile(ms, 50)),
        p90_ms=float(np.percentile(ms, 90)),
        p99_ms=float(np.percentile(ms, 99)),
        mean_ms=float(ms.mean()),
        n_frames=len(ms),
        clock=clock,
    )


def benchmark(
    engine: StreamingEngine,
    *,
    n_frames: int = 20,
    warmup: int = 3,
    frame_factory: Callable[[int], tuple] | None = None,
) -> FrameStats:
    """Per-request latency of ``engine`` over ``n_frames`` two-stream
    requests (host staging, copy, forward). On CUDA each request is timed
    with CUDA events around the call, after a synchronize; on the CPU with
    the host clock."""
    h, w = engine.height, engine.width
    rng = np.random.default_rng(0)

    def default_frame(_i):
        rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        d = (rng.random((h, w)) * 80 * (rng.random((h, w)) < 0.06)).astype(np.float32)
        return rgb, d, rgb.copy(), d.copy()

    make = frame_factory or default_frame
    frames = [make(i) for i in range(4)]
    cuda = engine.device.type == "cuda"
    for i in range(warmup):
        engine(*frames[i % 4])
    lat = np.empty(n_frames)
    for i in range(n_frames):
        if cuda:
            torch.cuda.synchronize(engine.device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            engine(*frames[i % 4])
            end.record()
            end.synchronize()
            lat[i] = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            engine(*frames[i % 4])
            lat[i] = time.perf_counter() - t0
    return _stats(lat, "cuda_events" if cuda else "host")
