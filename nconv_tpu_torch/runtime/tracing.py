"""The port's tracer: spans and counters on the host's ``perf_counter_ns``
clock, and device intervals from CUDA events put on the same clock.

The tracer is on between :func:`enable` and :func:`disable`, and also for
as long as a ``torch.profiler`` session records (one read of the
profiler's module flag). Off, a span site costs that check and nothing
else: no allocation, lock, clock read or CUDA event.

  * A span (:func:`span`) records its name, start and end, its thread, the
    innermost span open on that thread when it began (``parent``) and a
    frame id (spans of one frame share it). Inside a profiler session each
    span also enters ``torch.profiler.record_function`` on its own thread,
    so the profiler's timeline names what the host was doing.
  * A counter (:func:`count`) is an integer bumped at a span's boundary.
  * A device interval (:func:`device_begin` / :func:`device_end`) is a pair
    of timing events recorded on a stream. Once the end event has completed
    (polled by ``query()`` at the next interval, never waited for) it
    becomes a span on the host's clock: an anchor event's time on that
    clock plus the anchor's elapsed time to each event. An anchor is an
    event recorded on an idle side stream and watched (``query()``) until
    the device reaches it; it reads the middle of the record's call and
    the first query that found it done. One the device does not reach
    within :data:`ANCHOR_WAIT_NS` waits behind queued work (its stream
    shares a hardware queue with a busy one) and is taken again on
    another stream. A device keeps one anchor while its intervals follow
    each other, so that they all stand on one reading of the device's own
    clock (two anchors a second apart disagreed by up to 0.13 ms on a busy
    H100). It takes a new one at its first interval after :func:`enable`,
    after :data:`ANCHOR_IDLE_NS` without an interval (a new profiler
    session), and once the anchor is :data:`ANCHOR_AGE_NS` old
    (``elapsed_time`` is a float32 of ms: 2 us steps at 20 s).

Spans live in memory, at most :data:`CAPACITY`; past that a span is
dropped and ``tracing.spans_dropped`` counts it. :func:`collected`
returns them, :func:`clear` empties the store. :func:`idle_gaps` names
the host span running in each of the longest gaps between device frames.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 18
ANCHOR_AGE_NS = 60_000_000_000  # a device interval's anchor is at most this old when it begins
ANCHOR_IDLE_NS = 1_000_000_000  # an interval begun this long after the device's last takes a new anchor
ANCHOR_WAIT_NS = 100_000  # an anchor the device reaches later than this after its record is taken again
ANCHOR_TRIES = 8


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    thread: int | None  # threading.get_ident() of the host thread; None for a device interval
    parent: int  # id of the innermost span open on the thread at its start; 0 for none
    frame: int  # -1 where the span belongs to no frame
    id: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Anchor(NamedTuple):
    perf_ns: int  # the event's time on time.perf_counter_ns()'s clock
    event: object  # a torch.cuda.Event on an otherwise idle stream


class Gap(NamedTuple):
    start_ns: int
    ns: int
    span: str | None  # the innermost host span, on any thread, running at the gap's middle
    thread: int | None
    under: tuple  # the names of every host span running there


_enabled = False
_lock = threading.RLock()  # re-entered where a drained interval overflows the store
_spans: list[Span] = []
_counters: dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()  # .open: ids of the spans open on this thread
_threads: dict[int, str] = {}  # thread ident -> name
_pending: deque = deque()  # (name, frame, begin event, end event, anchor, device)
_free: dict = {}  # device -> timing events ready for reuse
_anchors: dict = {}  # device -> newest Anchor
_last: dict = {}  # device -> perf_counter_ns() of its last interval's begin
_sides: dict = {}  # device -> the side stream anchors are recorded on
_pair = (time.perf_counter_ns(), time.time_ns())  # (perf_counter_ns, time_ns) read together


def on() -> bool:
    return _enabled or _profiler._is_profiler_enabled


def enable() -> None:
    """Turn the tracer on until :func:`disable` (a running profiler session
    turns it on too). The next device interval on each device takes a new
    anchor."""
    global _enabled, _pair
    with _lock:
        _anchors.clear()
        _pair = (time.perf_counter_ns(), time.time_ns())
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "frame", "id", "parent", "start", "annotation")

    def __init__(self, name, frame):
        self.name, self.frame = name, frame

    def __enter__(self):
        stack = _open_stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.annotation = None
        if _profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        stack = _open_stack()
        if self.id in stack:  # a generator closed on another thread leaves it elsewhere
            stack.remove(self.id)
        _store(Span(self.name, self.start, end, threading.get_ident(), self.parent, self.frame, self.id))
        return False


def span(name: str, frame: int = -1):
    """A context manager that records a span of ``name`` while the tracer
    is on, and does nothing while it is off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, frame)


def _open_stack() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
        _threads[threading.get_ident()] = threading.current_thread().name
    return stack


def _store(s: Span) -> None:
    if len(_spans) < CAPACITY:
        _spans.append(s)
    else:
        _bump("tracing.spans_dropped")


def _bump(name: str) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + 1


def count(name: str) -> None:
    """Add one to counter ``name`` while the tracer is on."""
    if _enabled or _profiler._is_profiler_enabled:
        _bump(name)


# -- device intervals ---------------------------------------------------------


def _event(device):
    free = _free.get(device)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _anchor(device) -> Anchor:
    """The device's anchor, a new one where it has none, its last interval
    began :data:`ANCHOR_IDLE_NS` ago or the anchor is :data:`ANCHOR_AGE_NS`
    old. Call with ``_lock`` held."""
    global _pair
    a = _anchors.get(device)
    now = time.perf_counter_ns()
    last, _last[device] = _last.get(device, 0), now
    if a is None or now - last > ANCHOR_IDLE_NS or now - a.perf_ns > ANCHOR_AGE_NS:
        for _ in range(ANCHOR_TRIES):
            side = _sides.get(device)
            if side is None:
                side = _sides[device] = torch.cuda.Stream(device)
            ev = torch.cuda.Event(enable_timing=True)
            start = time.perf_counter_ns()
            ev.record(side)
            while True:
                done, now = ev.query(), time.perf_counter_ns()
                if done or now - start > ANCHOR_WAIT_NS:
                    break
            a = Anchor((start + now) // 2, ev)
            if done:
                break
            del _sides[device]  # the next of PyTorch's pooled streams
        _pair = (time.perf_counter_ns(), time.time_ns())
        _anchors[device] = a
    return a


def device_begin(stream):
    """Start a device interval on ``stream`` (a ``torch.cuda.Stream``): a
    token for :func:`device_end`, or ``None`` while the tracer is off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return None
    device = stream.device
    with _lock:
        anchor = _anchor(device)
        ev = _event(device)
    ev.record(stream)
    return ev, anchor, device


def device_end(begin, stream, name: str, frame: int) -> None:
    """End the interval ``begin`` (from :func:`device_begin`) on ``stream``;
    it is stored as span ``name`` once the device has reached it."""
    if begin is None:
        return
    ev, anchor, device = begin
    with _lock:
        end = _event(device)
    end.record(stream)
    with _lock:
        _pending.append((name, frame, ev, end, anchor, device))
        _drain()


def _drain() -> None:
    """Store the pending intervals whose events have completed, oldest
    first, and return their events to the pool. Call with ``_lock`` held."""
    while _pending:
        name, frame, begin, end, anchor, device = _pending[0]
        if not (end.query() and anchor.event.query()):
            return
        _pending.popleft()
        start = anchor.perf_ns + round(anchor.event.elapsed_time(begin) * 1e6)
        stop = anchor.perf_ns + round(anchor.event.elapsed_time(end) * 1e6)
        _store(Span(name, start, stop, None, 0, frame, next(_ids)))
        _free.setdefault(device, []).extend((begin, end))


# -- readers ------------------------------------------------------------------


def collected() -> list[Span]:
    """The stored spans (device intervals whose events have completed
    included), in the order they ended."""
    with _lock:
        _drain()
        return list(_spans)


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def clear() -> None:
    """Empty the store and the counters; intervals not yet completed are
    dropped."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _pending.clear()


def threads() -> dict[int, str]:
    """Thread ident -> name of every thread that opened a span."""
    return dict(_threads)


def wall_ns(perf_ns: int) -> int:
    """``perf_ns`` (a span's clock) on ``time.time_ns()``'s, which
    ``torch.profiler``'s traces stamp, through the newest pair of readings
    of both clocks (taken by :func:`enable` and with each anchor)."""
    perf, wall = _pair
    return wall + perf_ns - perf


def idle_gaps(n: int, spans: list[Span] | None = None) -> list[Gap]:
    """The ``n`` longest gaps between consecutive ``device.frame``
    intervals (of ``spans``, else of the store), longest first, each with
    the innermost (shortest) host span running at its middle, on any
    thread."""
    spans = collected() if spans is None else spans
    frames = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "device.frame")
    gaps, reach = [], None
    for start, end in frames:
        if reach is not None and start > reach:
            gaps.append((start - reach, reach))
        reach = end if reach is None else max(reach, end)
    host = sorted((s for s in spans if s.thread is not None), key=lambda s: s.start_ns)
    out, active, i = [], [], 0
    for length, start in sorted(sorted(gaps, reverse=True)[:n], key=lambda g: g[1]):
        mid = start + length // 2
        while i < len(host) and host[i].start_ns <= mid:
            active.append(host[i])
            i += 1
        active = [s for s in active if s.end_ns >= mid]
        around = sorted(active, key=lambda s: s.end_ns - s.start_ns)
        inner = around[0] if around else None
        out.append(Gap(start, length, inner and inner.name, inner and inner.thread,
                       tuple(s.name for s in around)))
    return sorted(out, key=lambda g: -g.ns)
