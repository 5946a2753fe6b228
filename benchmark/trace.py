"""The profiled slice of a traced run, and the arithmetic that metric
readers share.

A slice is a fixed number of units (frames, requests or steps) in the
middle of the window, run between two synchronizes under
``torch.profiler`` (CPU and CUDA activity: CUPTI names every kernel, also
those a CUDA graph replays). From it: each device event (name, start,
end), the busy time as the union of their intervals (a copy on one stream
may overlap a kernel on another), and the host op that was running in
each idle gap.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Traced:
    units: int  # frames, requests or steps in the slice
    window_s: float  # the slice's wall time
    events: list  # (name, start_us, end_us), device side
    busy_s: float
    idle: list  # [host op, seconds] of the longest idle gaps
    work: object  # work.Work of one unit
    unit_s: float | None  # wall seconds a unit outside the slice
    spans: dict = field(default_factory=dict)  # span -> ms of each unit outside the slice

    def device_s(self, match) -> tuple[float, int]:
        """Device seconds and count of the events whose name ``match``es."""
        hits = [(e - s) for name, s, e in self.events if match(name)]
        return sum(hits) / 1e6, len(hits)


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(run_slice, units: int, work, sync) -> Traced:
    """Run ``run_slice()`` (``units`` units) under the profiler, between
    two ``sync()`` calls."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_slice()
        sync()
        window = time.perf_counter() - t0
    device, host = [], []
    for evt in prof.events():
        span = (evt.name, evt.time_range.start, evt.time_range.end)
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if not evt.is_user_annotation:
                device.append(span)
        else:
            host.append(span)
    merged = _merge([(s, e) for _, s, e in device])
    busy = sum(e - s for s, e in merged) / 1e6
    gaps = sorted(((b - a, (a + b) / 2) for (_, a), (b, _) in zip(merged, merged[1:])), reverse=True)[:10]
    idle = []
    for length, mid in gaps:  # the innermost host op running at the gap's middle
        around = [(e - s, name) for name, s, e in host if s <= mid <= e]
        idle.append([min(around)[1] if around else "(no host op)", length / 1e6])
    return Traced(units, window, device, busy, idle, work, None)


def breakdown(traced: Traced) -> dict:
    """The ten device ops that took most time over the slice, and its ten
    longest idle gaps by the host op then running, in seconds."""
    per_op: dict[str, float] = {}
    for name, s, e in traced.events:
        per_op[name] = per_op.get(name, 0.0) + (e - s) / 1e6
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": traced.idle}


# -- what metric readers share ---------------------------------------------


def device_ms(traced: Traced, symbols) -> float | None:
    """Device ms a unit of the kernels whose name holds one of ``symbols``."""
    seconds, n = traced.device_s(lambda name: any(s in name for s in symbols))
    return seconds * 1e3 / traced.units if n else None


def device_ms_outside(traced: Traced, symbols) -> float | None:
    """Device ms a unit of every event whose name holds none of ``symbols``."""
    seconds, n = traced.device_s(lambda name: not any(s in name for s in symbols))
    return seconds * 1e3 / traced.units if n else None


def roofline(traced: Traced) -> float | None:
    """The unit's least time over its device busy time, %."""
    if not traced.busy_s:
        return None
    return 100.0 * traced.work.least_s / (traced.busy_s / traced.units)


def mfu(traced: Traced) -> float | None:
    """The unit's operations at the peak of their dtypes over the wall time
    a unit took outside the slice, %."""
    if not traced.unit_s:
        return None
    return 100.0 * traced.work.flops_s / traced.unit_s


def idle_share(traced: Traced) -> float | None:
    if not traced.busy_s:
        return None
    return 100.0 * (1.0 - traced.busy_s / traced.window_s)


def span_p50(traced: Traced, span: str) -> float | None:
    values = traced.spans.get(span)
    return statistics.median(values) if values else None
