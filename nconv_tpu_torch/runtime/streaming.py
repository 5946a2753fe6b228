"""Streaming inference engine: two camera streams at batch 1.

  host frames (HWC uint8 or float RGB, HW float sparse depth)
    -> wire encode on the host (:mod:`.wires`) straight into a staging slot
       (pinned on the card): RGB dense uint8 / float32, or YUV 4:2:0 / 4:2:2
       planes; depth dense uint16 fixed point clip(d * 256, 0, 65535)
       truncated (the KITTI PNG encoding), dense float32, or COO (flat
       index int32, uint16 value) of a static capacity
    -> one host-to-device copy of the slot on a copy stream
    -> on the caller's stream: a device-to-device copy into the graph's
       static input, one replay of the captured frame graph, and a copy of
       its outputs (the result stays valid after the next request):
         decode: uint16 / 256 in f32; COO rasterized by ``index_add_``;
         YUV chroma upsampled and inverted in the RGB compute dtype (bf16
         arithmetic in the mixed schedule); a dense uint8 RGB frame enters
         the first conv as uint8 and is decoded there;
         GuidedDepthNet.export (BatchNorm folded unless ``fold_bn=False``)
    -> border-masked dense depth per stream

On the CPU the same decode and export run eagerly on the staged wire, with
no graph. On the card every request replays the graph: if capture or
replay fails, the engine raises; it never serves eagerly there. The
static buffers are the port's form of the JAX engine's ``donate``.
"""
from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass
from typing import Any, Callable, Iterable, Iterator, Mapping

import numpy as np
import torch

from .. import kernels
from ..models import GuidedDepthNet, maybe_fold, resolve_device
from . import wires

# wire dtypes as the device holds them: uint16 as int16 (decoded & 0xFFFF)
_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16,
                np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}
_ALIGN = 64  # bytes; every wire array starts on such a boundary of its slot


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass
class FrameStats:
    fps: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    mean_ms: float
    n_frames: int
    clock: str  # "cuda_events" or "host"

    def as_dict(self) -> dict:
        return asdict(self)


class _Layout:
    """Where each wire array of a two-stream frame lies in one byte buffer:
    ``fields[(stream, name)] = (offset, shape, numpy dtype)``, shapes with
    the batch axis first."""

    def __init__(self, arrays: list[tuple[str, tuple[int, ...], np.dtype]]):
        self.fields: dict[tuple[int, str], tuple[int, tuple[int, ...], np.dtype]] = {}
        off = 0
        for s in (0, 1):
            for name, shape, dt in arrays:
                self.fields[(s, name)] = (off, shape, np.dtype(dt))
                off = _round_up(off + int(np.prod(shape)) * np.dtype(dt).itemsize, _ALIGN)
        self.nbytes = off

    def numpy_views(self, buf: np.ndarray) -> dict[tuple[int, str], np.ndarray]:
        return {k: buf[off:off + int(np.prod(shape)) * dt.itemsize].view(dt).reshape(shape)
                for k, (off, shape, dt) in self.fields.items()}

    def tensor_views(self, buf: torch.Tensor) -> dict[tuple[int, str], torch.Tensor]:
        return {k: buf[off:off + int(np.prod(shape)) * dt.itemsize].view(_TORCH_DTYPE[dt]).view(shape)
                for k, (off, shape, dt) in self.fields.items()}


class _Slot:
    """One staging slot: the frame's wire bytes on the host (pinned on the
    card), their copy on the device, and the two events that guard reuse:
    ``copied`` (host-to-device copy done: the host may write again) and
    ``consumed`` (the copy into the graph's input done: the device copy may
    be overwritten)."""

    def __init__(self, layout: _Layout, device: torch.device):
        card = device.type == "cuda"
        self.host = torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=card)
        self.arrays = layout.numpy_views(self.host.numpy())
        self.dev = torch.empty(layout.nbytes, dtype=torch.uint8, device=device) if card else self.host
        self.copied = torch.cuda.Event() if card else None
        self.consumed = torch.cuda.Event() if card else None


def _capture(fn: Callable[[], Any], device: torch.device, warm_runs: int):
    """Run ``fn`` eagerly ``warm_runs`` times on a side stream (every
    kernel form's first call, every table build), then capture one call as
    a CUDA graph (default capture error mode). Returns (graph, the
    captured call's outputs, the launch counts of the capture: one call's
    kernels, which every replay launches again)."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warm_runs):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        after = kernels.launch_counts()
    return graph, out, {k: n - before[k] for k, n in after.items() if n != before[k]}


def _up2(c: torch.Tensor, axis: int, cosited: bool) -> torch.Tensor:
    """Chroma 2x along ``axis`` (edges replicate). 4:2:0 samples are box
    means (at 2k + 0.5): pixel 2k = 3/4 c[k] + 1/4 c[k-1], 2k+1 = 3/4 c[k] +
    1/4 c[k+1]. 4:2:2 samples are co-sited (at 2k): even pixels exact, odd
    the midpoint."""
    n = c.shape[axis]
    prev = torch.cat([c.narrow(axis, 0, 1), c.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([c.narrow(axis, 1, n - 1), c.narrow(axis, n - 1, 1)], axis)
    if cosited:
        ev, od = c, 0.5 * c + 0.5 * nxt
    else:
        ev, od = 0.75 * c + 0.25 * prev, 0.75 * c + 0.25 * nxt
    shape = list(c.shape)
    shape[axis] *= 2
    return torch.stack([ev, od], axis + 1).reshape(shape)


class StreamingEngine:
    """``engine(rgb0, d0, rgb1, d1)`` takes host numpy frames (HWC uint8 or
    float RGB, HW float sparse depth; for a YUV wire also pre-encoded
    ``(y, u, v)`` planes, for the COO wire ``(idx, val)``) and returns the
    two dense depth maps ``(1, H, W, 1)`` on the engine's device, fresh
    tensors each call.

    ``state_dict`` holds the port's (unfolded or folded) weights, e.g. from
    :func:`nconv_tpu_torch.convert.from_jax_variables`; BatchNorm is folded
    on construction unless ``fold_bn=False``. ``model`` replaces the default
    ``GuidedDepthNet(dtype=compute_dtype)`` (e.g. ``step1_pos_fn="identity"``
    for a converted reference checkpoint); ``compute_dtype=torch.bfloat16``
    runs the mixed schedule (bf16 feature convs, f32 step 1 and depth path).
    The wire options are the JAX engine's, with the same names and
    defaults. On the card, construction warms every kernel form and
    captures the frame as one CUDA graph. One caller at a time.
    """

    DEPTH_SCALE = 256.0
    WARM_RUNS = 2  # eager frames before the capture

    def __init__(
        self,
        state_dict: Mapping[str, torch.Tensor],
        *,
        height: int,
        width: int,
        model: GuidedDepthNet | None = None,
        compute_dtype: torch.dtype = torch.float32,
        rgb_wire_dtype=np.uint8,
        rgb_wire: str = "dense",  # 'dense' | 'yuv420' | 'yuv422'
        depth_wire_dtype=np.uint16,
        depth_wire: str = "dense",  # 'dense' | 'coo'
        coo_capacity: int | None = None,
        fold_bn: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        model = (model or GuidedDepthNet(dtype=compute_dtype, device=self.device)).to(self.device)
        if fold_bn:
            model, state = maybe_fold(model, state_dict)
        else:
            state = dict(state_dict)
        model.load_state_dict({k: v.to(self.device) for k, v in state.items()})
        self.model = model.eval()
        self.height, self.width = height, width
        self.rgb_dtype = model.dtype  # the feature convs' dtype; step 1 and depth stay f32
        self.rgb_wire_dtype = np.dtype(rgb_wire_dtype)
        self.depth_wire_dtype = np.dtype(depth_wire_dtype)
        if rgb_wire not in ("dense", "yuv420", "yuv422"):
            raise ValueError(f"rgb_wire {rgb_wire!r}")
        if depth_wire not in ("dense", "coo"):
            raise ValueError(f"depth_wire {depth_wire!r}")
        if self.rgb_wire_dtype not in (np.uint8, np.float32) or self.depth_wire_dtype not in (np.uint16, np.float32):
            raise ValueError(f"wire dtypes {self.rgb_wire_dtype} / {self.depth_wire_dtype}")
        if rgb_wire != "dense" and (width % 2 or (rgb_wire == "yuv420" and height % 2)
                                    or self.rgb_wire_dtype != np.uint8):
            raise ValueError(f"{rgb_wire} needs a uint8 wire and an even {height}x{width}")
        if rgb_wire == "yuv420":
            warnings.warn(
                "rgb_wire='yuv420' trades accuracy for wire size: worst-case "
                "output parity vs the dense wire is ~2.6e-3 rel RMSE (beyond "
                "the 1e-3 bar; natural camera content measures far lower). "
                "rgb_wire='yuv422' (2 B/px, co-sited chroma) sits at the "
                "u8-YUV quantization floor (~1e-3 worst case, <1e-3 on "
                "camera-like content); only 'dense' (3 B/px) holds <1e-3 on "
                "any content.",
                stacklevel=2,
            )
        self.rgb_wire, self.depth_wire = rgb_wire, depth_wire
        self.coo_capacity = coo_capacity if coo_capacity is not None else _round_up(height * width // 8, 512)
        self.coo_dropped_points = 0  # over-capacity points lost
        self._coo_warned = False
        self._lock = threading.Lock()  # the COO count: staging workers share it
        # BT.601 inverse constants rounded to the RGB dtype, as the JAX
        # decode's weakly typed scalars are
        self._yuv_consts = [torch.tensor(c, dtype=self.rgb_dtype).item() for c in (1.402, 0.344136, 0.714136, 1.772)]

        h, w = height, width
        if rgb_wire == "dense":
            rgb = [("rgb", (1, h, w, 3), self.rgb_wire_dtype)]
        else:
            ch = (h // 2, w // 2) if rgb_wire == "yuv420" else (h, w // 2)
            rgb = [("y", (1, h, w), np.uint8), ("u", (1, *ch), np.uint8), ("v", (1, *ch), np.uint8)]
        if depth_wire == "coo":
            depth = [("idx", (1, self.coo_capacity), np.int32), ("val", (1, self.coo_capacity), np.uint16)]
        else:
            depth = [("depth", (1, h, w, 1), self.depth_wire_dtype)]
        self._layout = _Layout(rgb + depth)
        self._rgb_names = [n for n, _, _ in rgb]
        self._depth_names = [n for n, _, _ in depth]
        self._ring: list[_Slot] = []
        self._next = 0
        self._graph = None
        self.capture_counts: dict[str, int] = {}
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._static_in = torch.zeros(self._layout.nbytes, dtype=torch.uint8, device=self.device)
            self._graph, self._static_out, self.capture_counts = _capture(
                lambda: self.forward_staged(self._static_in), self.device, self.WARM_RUNS)

    # -- wire -----------------------------------------------------------------

    @property
    def wire_bytes_per_frame(self) -> int:
        """Host->device bytes per two-stream frame (the arrays themselves,
        without the slot's alignment)."""
        return sum(int(np.prod(shape)) * dt.itemsize for _, shape, dt in self._layout.fields.values())

    def _encode_coo(self, depth, out) -> None:
        _, _, n = wires.encode_depth_coo(depth, self.coo_capacity, self.DEPTH_SCALE, out=out)
        if n > self.coo_capacity:
            with self._lock:
                self.coo_dropped_points += n - self.coo_capacity
                warn, self._coo_warned = not self._coo_warned, True
            if warn:
                warnings.warn(
                    f"COO depth wire capacity {self.coo_capacity} exceeded ({n} nonzero points); "
                    "excess points are dropped: raise coo_capacity or use the dense wire "
                    "(depth_wire='dense') for streams this dense",
                    stacklevel=4,
                )

    def _frame_array(self, a, channels: int, what: str) -> np.ndarray:
        """``a`` as (1, H, W, channels): an (H, W) or (H, W, C) frame gains
        its leading axes, any other shape raises."""
        a = np.asarray(a)
        if a.ndim == 2:
            a = a[:, :, None]
        if a.ndim == 3:
            a = a[None]
        if a.shape != (1, self.height, self.width, channels):
            raise ValueError(f"{what} frame {a.shape} != {(1, self.height, self.width, channels)}")
        return a

    def _encode(self, frame, arrays) -> None:
        """Write the wire form of host ``frame`` into a slot's ``arrays``."""
        for s in (0, 1):
            rgb, depth = frame[2 * s], frame[2 * s + 1]
            if isinstance(rgb, tuple):  # pre-encoded (y, u, v)
                for name, plane in zip(self._rgb_names, rgb):
                    arrays[(s, name)][0] = plane
            else:
                a = self._frame_array(rgb, 3, "rgb")
                if self.rgb_wire_dtype == np.uint8 and a.dtype != np.uint8:
                    a = np.clip(a, 0, 255).astype(np.uint8)
                if self.rgb_wire == "dense":
                    arrays[(s, "rgb")][...] = a
                else:
                    enc = wires.encode_yuv420 if self.rgb_wire == "yuv420" else wires.encode_yuv422
                    enc(a[0], out=tuple(arrays[(s, n)][0] for n in self._rgb_names))
            if isinstance(depth, tuple):  # pre-encoded (idx, val)
                arrays[(s, "idx")][...], arrays[(s, "val")][...] = depth
            elif self.depth_wire == "coo":
                self._encode_coo(self._frame_array(depth, 1, "depth"), (arrays[(s, "idx")], arrays[(s, "val")]))
            elif self.depth_wire_dtype == np.uint16 and np.asarray(depth).dtype != np.uint16:
                wires.encode_depth_wire(self._frame_array(depth, 1, "depth"), self.DEPTH_SCALE,
                                        out=arrays[(s, "depth")])
            else:
                arrays[(s, "depth")][...] = self._frame_array(depth, 1, "depth")

    def _stage_into(self, slot: _Slot, frame) -> _Slot:
        """Encode ``frame`` into ``slot`` and start its copy to the device,
        once the slot's previous copies are done."""
        card = self.device.type == "cuda"
        if card:
            slot.copied.synchronize()
        self._encode(frame, slot.arrays)
        if card:
            with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(slot.consumed)
                slot.dev.copy_(slot.host, non_blocking=True)
                slot.copied.record(self._copy_stream)
        return slot

    def _slots(self, n: int) -> list[_Slot]:
        while len(self._ring) < n:
            self._ring.append(_Slot(self._layout, self.device))
        return self._ring

    def stage(self, rgb0, depth0, rgb1, depth1) -> torch.Tensor:
        """The frame's wire bytes as a new uint8 tensor on the engine's
        device, ready on the current stream (for :meth:`forward_staged` and
        :meth:`replay`)."""
        slot = self._stage_into(self._slots(1)[0], (rgb0, depth0, rgb1, depth1))
        if self.device.type != "cuda":
            return slot.host.clone()
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(slot.copied)
        wire = slot.dev.clone()
        slot.consumed.record(stream)
        return wire

    # -- the frame ------------------------------------------------------------

    def decode(self, wire: torch.Tensor):
        """``(rgb0, depth0, rgb1, depth1)`` model inputs from a staged wire:
        RGB NHWC in uint8 (dense uint8 wire) or the RGB dtype, depth
        ``(1, H, W, 1)`` f32."""
        views = self._layout.tensor_views(wire)
        out = []
        for s in (0, 1):
            out.append(self._decode_rgb([views[(s, n)] for n in self._rgb_names]))
            out.append(self._decode_depth([views[(s, n)] for n in self._depth_names]))
        return out

    def _decode_rgb(self, planes):
        if self.rgb_wire == "dense":
            x = planes[0]
            return x if x.dtype == torch.uint8 else x.to(self.rgb_dtype)
        dt = self.rgb_dtype
        y, u, v = (p.to(dt) for p in planes)
        u, v = u - 128, v - 128
        if self.rgb_wire == "yuv420":  # rows subsampled too
            u, v = _up2(u, 1, False), _up2(v, 1, False)
        u, v = _up2(u, 2, self.rgb_wire == "yuv422"), _up2(v, 2, self.rgb_wire == "yuv422")
        cr, cgu, cgv, cb = self._yuv_consts
        return torch.stack([y + cr * v, y - cgu * u - cgv * v, y + cb * u], -1).clamp(0, 255)

    def _decode_depth(self, arrays):
        if self.depth_wire == "coo":
            idx, val = arrays
            canvas = torch.zeros(self.height * self.width, dtype=torch.float32, device=idx.device)
            # unique indices but for the padding, (0, 0), which adds exact zeros
            canvas.index_add_(0, idx[0], (val[0].to(torch.int32) & 0xFFFF).to(torch.float32) / self.DEPTH_SCALE)
            return canvas.view(1, self.height, self.width, 1)
        x = arrays[0]
        if x.dtype == torch.int16:  # the uint16 wire
            return (x.to(torch.int32) & 0xFFFF).to(torch.float32) / self.DEPTH_SCALE
        return x

    @torch.no_grad()
    def forward_staged(self, wire: torch.Tensor):
        """The frame, eagerly: decode and export of a staged wire. The
        graph replays this; on the CPU every request runs it."""
        return self.model.export(*self.decode(wire))

    def replay(self, wire: torch.Tensor):
        """The frame on a staged wire (:meth:`stage`): on the card a copy
        into the graph's input, one replay and fresh outputs; on the CPU
        :meth:`forward_staged`."""
        if self._graph is None:
            return self.forward_staged(wire)
        with torch.cuda.device(self.device):
            self._static_in.copy_(wire)
            self._graph.replay()
            return tuple(o.clone() for o in self._static_out)

    def _dispatch(self, slot: _Slot):
        """The frame on ``slot``'s wire, once its copy is done."""
        if self._graph is None:
            return self.replay(slot.dev)
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(slot.copied)
        out = self.replay(slot.dev)
        slot.consumed.record(stream)
        return out

    def __call__(self, rgb0, depth0, rgb1, depth1):
        ring = self._slots(2)
        slot = ring[self._next % len(ring)]
        self._next += 1
        return self._dispatch(self._stage_into(slot, (rgb0, depth0, rgb1, depth1)))

    def warmup(self) -> None:
        """One request of zero frames, waited for."""
        z = np.zeros((self.height, self.width), np.float32)
        r = np.zeros((self.height, self.width, 3), np.float32)
        self(r, z, r, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(
        self,
        frames: Iterable[tuple],
        *,
        depth: int = 2,
        sink: Callable[[Any, Any], None] | None = None,
        stage_ahead: int = 4,
        stage_workers: int = 2,
    ) -> Iterator[tuple]:
        """Pipelined streaming loop: keeps ``depth`` frames in flight.

        ``frames`` yields (rgb0, d0, rgb1, d1) host tuples. Encode and
        host-to-device copy run on a pool of ``stage_workers`` threads, up
        to ``stage_ahead`` frames ahead, each into its own slot of a ring of
        ``stage_ahead + depth + 1``; this thread waits on each slot's copy,
        replays the graph and yields results in order (fresh tensors).
        """
        ring = self._slots(stage_ahead + depth + 1)[: stage_ahead + depth + 1]
        pool = ThreadPoolExecutor(max_workers=max(1, stage_workers))
        try:
            staged: deque = deque()
            inflight: deque = deque()
            it = iter(frames)
            n, exhausted = 0, False
            while True:
                while not exhausted and len(staged) < stage_ahead:
                    try:
                        frame = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    # slot n's last frame (n - len(ring)) was dispatched:
                    # at most stage_ahead frames wait in `staged`
                    staged.append(pool.submit(self._stage_into, ring[n % len(ring)], frame))
                    n += 1
                if staged:
                    inflight.append(self._dispatch(staged.popleft().result()))
                elif not inflight:
                    break
                while len(inflight) > depth or (exhausted and not staged and inflight):
                    out = inflight.popleft()
                    if sink is not None:
                        sink(*out)
                    yield out
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


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
    n_frames: int = 100,
    warmup: int = 10,
    frame_factory: Callable[[int], tuple] | None = None,
    include_e2e: bool = True,
    window: int = 10,
) -> dict[str, FrameStats]:
    """Steady-state per-frame cost of ``engine``, as three clocks:

      ``device``: ``window`` back-to-back frames on staged wires (copy into
        the graph's input, replay, output copy) per window, over ``window``;
        CUDA events on the card, the host clock on the CPU;
      ``synced``: one frame on a staged wire, then a synchronize, on the
        host clock;
      ``e2e``: ``synced`` plus the host encode and the host-to-device copy
        of the wire (``engine(*frame)``).
    """
    h, w = engine.height, engine.width
    rng = np.random.default_rng(0)

    def default_frame(_i):
        rgb = (rng.random((h, w, 3)) * 255).astype(np.float32)
        d = (rng.random((h, w)) * 80 * (rng.random((h, w)) < 0.06)).astype(np.float32)
        return rgb, d, rgb.copy(), d.copy()

    make = frame_factory or default_frame
    frames = [make(i) for i in range(4)]
    staged = [engine.stage(*f) for f in frames]
    card = engine.device.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize(engine.device)

    for i in range(max(warmup, 2)):
        engine.replay(staged[i % len(staged)])
    sync()

    n_windows = max(3, n_frames // window)
    per_frame = np.empty(n_windows)
    for j in range(n_windows):
        if card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(window):
            engine.replay(staged[(j * window + i) % len(staged)])
        if card:
            end.record()
            end.synchronize()
            per_frame[j] = start.elapsed_time(end) / 1e3 / window
        else:
            per_frame[j] = (time.perf_counter() - t0) / window
    results = {"device": _stats(per_frame, "cuda_events" if card else "host")}

    n_sync = max(4, n_frames // 4)
    lat = np.empty(n_sync)
    for i in range(n_sync):
        t0 = time.perf_counter()
        engine.replay(staged[i % len(staged)])
        sync()
        lat[i] = time.perf_counter() - t0
    results["synced"] = _stats(lat, "host")

    if include_e2e:
        lat = np.empty(n_sync)
        for i in range(n_sync):
            t0 = time.perf_counter()
            engine(*frames[i % len(frames)])
            sync()
            lat[i] = time.perf_counter() - t0
        results["e2e"] = _stats(lat, "host")
    return results


def benchmark_throughput(
    state_dict: Mapping[str, torch.Tensor],
    *,
    height: int,
    width: int,
    batch: int = 8,
    compute_dtype: torch.dtype = torch.bfloat16,
    n_iters: int = 50,
    model: GuidedDepthNet | None = None,
    device=None,
) -> float:
    """Batched two-stream throughput (frames/s, 2 x ``batch`` x iterations
    over seconds): the JAX bench's float RGB in [0, 1) and sparse depth at
    ``batch`` through both streams (2 x ``batch`` in the net), BatchNorm
    folded, in ``compute_dtype``; a captured graph replayed ``n_iters``
    times on the card, eager calls on the CPU."""
    dev = resolve_device(device)
    model = (model or GuidedDepthNet(dtype=compute_dtype, device=dev)).to(dev)
    model, state = maybe_fold(model, state_dict)
    model.load_state_dict({k: v.to(dev) for k, v in state.items()})
    model.eval()
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.random((batch, height, width, 3)).astype(np.float32)).to(dev, compute_dtype)
    shape = (batch, height, width, 1)
    d = torch.from_numpy((rng.random(shape) * (rng.random(shape) < 0.06)).astype(np.float32)).to(dev, compute_dtype)
    fn = lambda: model.export(rgb, d, rgb, d)
    if dev.type == "cuda":
        graph, _, _ = _capture(fn, dev, 2)
        call = graph.replay
        sync = lambda: torch.cuda.synchronize(dev)
    else:
        fn()
        call, sync = fn, lambda: None
    sync()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        call()
    sync()
    return 2 * batch * n_iters / (time.perf_counter() - t0)
