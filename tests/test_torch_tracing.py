"""The port's tracer (``nconv_tpu_torch/runtime/tracing.py``) and the spans
and counters ``StreamingEngine`` leaves in it, on the CPU: nothing while
it is off, the spans of a request and of ``run()`` nested by thread and
frame, a profiler session turning it on, the store's bound, device
intervals put on the host's clock (with stand-in events: the CPU has no
CUDA ones), the gaps between device frames named by the host span under
them, the ``kernels.build`` span, and ``runtime/profile.py``'s readers."""
import collections
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nconv_tpu_torch import kernels
from nconv_tpu_torch.models import GuidedDepthNet
from nconv_tpu_torch.runtime import StreamingEngine, profile, tracing
from nconv_tpu_torch.runtime.tracing import Span

H, W = 32, 32


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def engine():
    return StreamingEngine(GuidedDepthNet(device="cpu").state_dict(), height=H, width=W, device="cpu")


def frames(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        rgb = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        d = (rng.random((H, W)) * 80 * (rng.random((H, W)) < 0.05)).astype(np.float32)
        out.append((rgb, d, rgb, d))
    return out


def by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


class FakeEvent:
    """A timing event of the host's clock: recorded at once, complete at
    once, ``elapsed_time`` in ms."""

    built = 0

    def __init__(self, enable_timing=False):
        FakeEvent.built += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def query(self):
        return self.t is not None

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


class FakeStream:
    def __init__(self, device="cuda:0"):
        self.device = torch.device(device)


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.built = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(tracing, "_free", {})
    monkeypatch.setattr(tracing, "_anchors", {})
    monkeypatch.setattr(tracing, "_last", {})
    monkeypatch.setattr(tracing, "_sides", {})
    return FakeEvent


def test_off_the_engine_leaves_nothing_and_builds_no_event(engine, monkeypatch):
    built = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: built.append(1))
    f = frames(3)
    engine(*f[0])
    assert len(list(engine.run(f))) == 3
    assert tracing.device_begin(FakeStream()) is None
    tracing.device_end(None, FakeStream(), "device.frame", 0)
    tracing.count("engine.dispatched")
    assert tracing.collected() == [] and tracing.counters() == {} and built == []
    assert not tracing.on()


def test_a_request_nests_its_spans_under_one_frame(engine):
    tracing.enable()
    engine(*frames(1)[0])
    spans = by_name(tracing.collected())
    (request,), (stage,), (replay,) = spans["engine.request"], spans["engine.stage"], spans["engine.replay"]
    assert request.parent == 0 and stage.parent == request.id and replay.parent == request.id
    inner = spans["engine.slot_wait"] + spans["engine.encode"] + spans["engine.h2d"]
    # one engine.encode: the dense u8 frame is encoded by one parallel call
    assert [len(spans[n]) for n in ("engine.slot_wait", "engine.encode", "engine.h2d")] == [1, 1, 1]
    assert all(s.parent == stage.id for s in inner)
    assert {s.frame for v in spans.values() for s in v} == {request.frame}
    assert {s.thread for v in spans.values() for s in v} == {threading.get_ident()}
    assert request.start_ns <= stage.start_ns < stage.end_ns <= replay.start_ns < replay.end_ns <= request.end_ns


def test_stage_then_replay_share_one_frame(engine):
    tracing.enable()
    f = frames(2)
    engine.replay(engine.stage(*f[0]))
    engine.replay(engine.stage(*f[1]))
    spans = tracing.collected()
    first, second = spans[:len(spans) // 2], spans[len(spans) // 2:]
    for half in (first, second):
        assert sorted(s.name for s in half) == sorted(
            ["engine.stage", "engine.slot_wait", "engine.encode", "engine.h2d", "engine.replay"])
        assert len({s.frame for s in half}) == 1
    assert first[0].frame != second[0].frame
    wire = engine.stage(*f[0])
    engine.replay(wire)
    engine.replay(wire)  # a second replay of one stage takes an id of its own
    spans = by_name(tracing.collected())
    replays = [s.frame for s in spans["engine.replay"]]
    assert len(set(replays)) == 4 and set(replays[:3]) == {s.frame for s in spans["engine.stage"]}


@pytest.mark.parametrize("stage_workers", [1, 2])
def test_run_stages_on_workers_and_waits_on_the_caller(engine, stage_workers):
    tracing.enable()
    n = 5
    assert len(list(engine.run(frames(n), stage_workers=stage_workers))) == n
    spans = by_name(tracing.collected())
    main = threading.get_ident()
    assert len({s.frame for s in spans["engine.stage"]}) == n
    assert all(s.thread != main for s in spans["engine.stage"] + spans["engine.encode"])
    for name in ("engine.await_staged", "engine.replay", "engine.consumer"):
        assert sorted(s.frame for s in spans[name]) == sorted(s.frame for s in spans["engine.stage"])
        assert all(s.thread == main for s in spans[name])
    assert tracing.threads()[main] == threading.current_thread().name


def test_counters_agree_with_the_spans(engine):
    tracing.enable()
    f = frames(4)
    list(engine.run(f))
    engine(*f[0])
    engine(*f[1])
    spans, counters = by_name(tracing.collected()), tracing.counters()
    assert counters["engine.dispatched"] == len(spans["engine.replay"]) == 6
    assert counters["engine.dispatched"] == len(spans["engine.await_staged"]) + len(spans["engine.request"])
    assert 0 <= counters.get("engine.await_blocked", 0) <= len(spans["engine.await_staged"])
    assert "engine.slot_blocked" not in counters  # the CPU's slots have no copy to wait for


def test_a_profiler_session_turns_the_tracer_on_and_names_its_ranges(engine):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.on()
        engine(*frames(1)[0])
    assert not tracing.on()
    names = {e.name for e in prof.events()}
    expected = {"engine.request", "engine.stage", "engine.slot_wait", "engine.encode", "engine.h2d", "engine.replay"}
    assert expected <= names
    assert expected == {s.name for s in tracing.collected()}
    engine(*frames(1)[0])  # off again
    assert len(tracing.collected()) == 6  # one span of each name: the frame is encoded by one call


def test_the_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 5)
    tracing.enable()
    for i in range(8):
        with tracing.span("x", i):
            pass
    assert [s.frame for s in tracing.collected()] == [0, 1, 2, 3, 4]
    assert tracing.counters() == {"tracing.spans_dropped": 3}
    tracing.clear()
    assert tracing.collected() == [] and tracing.counters() == {}


def test_threads_lose_no_span_and_no_count():
    """More threads than cores, switching often: every span and every
    count arrives, each thread's spans nested under its own."""
    tracing.enable()
    threads, rounds = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(rounds):
                with tracing.span("outer", k):
                    with tracing.span("inner", k):
                        tracing.count("n")
        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = tracing.collected()
    assert tracing.counters() == {"n": threads * rounds}
    assert len(spans) == 2 * threads * rounds
    outer = {s.id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            p = outer[s.parent]
            assert p.thread == s.thread and p.frame == s.frame and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_device_intervals_go_on_the_host_clock_from_a_pool(fake_cuda):
    stream = FakeStream()
    assert tracing.device_begin(stream) is None and fake_cuda.built == 0  # off
    tracing.enable()
    t0 = time.perf_counter_ns()
    begin = tracing.device_begin(stream)
    time.sleep(0.002)
    tracing.device_end(begin, stream, "device.frame", 7)
    t1 = time.perf_counter_ns()
    assert fake_cuda.built == 3  # the anchor, and the interval's two
    begin = tracing.device_begin(stream)
    tracing.device_end(begin, stream, "device.h2d", 8)
    assert fake_cuda.built == 3  # the pool's events again, the anchor still young
    frame, h2d = tracing.collected()
    assert (frame.name, frame.frame, frame.thread, h2d.frame) == ("device.frame", 7, None, 8)
    assert t0 <= frame.start_ns and frame.end_ns <= t1 and frame.ms >= 2.0
    assert frame.end_ns <= h2d.start_ns


@pytest.mark.parametrize("limit", ["ANCHOR_AGE_NS", "ANCHOR_IDLE_NS"])
def test_an_anchor_is_taken_again_when_old_or_after_a_pause(fake_cuda, monkeypatch, limit):
    tracing.enable()
    stream = FakeStream()
    for frame in range(3):
        tracing.device_end(tracing.device_begin(stream), stream, "device.frame", frame)
    assert fake_cuda.built == 1 + 2  # one anchor while intervals follow each other
    monkeypatch.setattr(tracing, limit, 0)
    for frame in range(3, 6):
        time.sleep(0.001)
        tracing.device_end(tracing.device_begin(stream), stream, "device.frame", frame)
    assert fake_cuda.built == 1 + 3 + 2  # an anchor each interval; the intervals' events reused


def test_an_anchor_behind_queued_work_is_taken_on_another_stream(fake_cuda, monkeypatch):
    """The first side stream shares a hardware queue with queued work: the
    device does not reach its event, so the anchor moves to the next."""
    sides = []

    class Side(FakeStream):
        def __init__(self, device="cuda:0"):
            super().__init__(device)
            sides.append(self)

    class Event(FakeEvent):
        def record(self, stream=None):
            super().record(stream)
            self.stream = stream

        def query(self):
            return self.t is not None and self.stream is not sides[0]

    monkeypatch.setattr(torch.cuda, "Stream", Side)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    tracing.enable()
    stream = FakeStream()
    t0 = time.perf_counter_ns()
    tracing.device_end(tracing.device_begin(stream), stream, "device.frame", 0)
    assert len(sides) == 2 and time.perf_counter_ns() - t0 >= tracing.ANCHOR_WAIT_NS
    (s,) = tracing.collected()
    assert t0 <= s.start_ns <= s.end_ns <= time.perf_counter_ns()


def test_intervals_wait_for_their_events(fake_cuda):
    class Late(FakeEvent):
        done = False

        def query(self):
            return Late.done

    end = Late()
    end.record()
    anchor = FakeEvent()
    anchor.record()
    begin = FakeEvent()
    begin.record()
    with tracing._lock:
        tracing._pending.append(("device.frame", 1, begin, end, tracing.Anchor(0, anchor), "cuda:0"))
    assert tracing.collected() == []
    Late.done = True
    (s,) = tracing.collected()
    assert s.name == "device.frame" and s.start_ns == begin.t - anchor.t and s.end_ns == end.t - anchor.t


def span(name, start, end, thread=1, frame=-1):
    return Span(name, start, end, thread, 0, frame, 0)


def test_idle_gaps_name_the_innermost_host_span_at_each_gap():
    spans = [
        span("device.frame", 0, 100, None), span("device.frame", 130, 200, None),  # gap 30 at 100
        span("device.frame", 200, 300, None), span("device.frame", 400, 500, None),  # gap 100 at 300
        span("device.frame", 510, 600, None),  # gap 10 at 500, under no span
        span("engine.await_staged", 90, 450, thread=1),
        span("engine.encode", 320, 380, thread=2),
        span("engine.replay", 100, 120, thread=1),
    ]
    gaps = tracing.idle_gaps(10, spans)
    assert [(g.start_ns, g.ns, g.span, g.thread) for g in gaps] == [
        (300, 100, "engine.encode", 2), (100, 30, "engine.replay", 1), (500, 10, None, None)]
    assert gaps[0].under == ("engine.encode", "engine.await_staged")
    assert [g.ns for g in tracing.idle_gaps(1, spans)] == [100]


def test_kernels_build_opens_a_span(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_compile", lambda so: time.sleep(0.001))
    kernels.build()
    assert tracing.collected() == []
    tracing.enable()
    kernels.build()
    (s,) = tracing.collected()
    assert s.name == "kernels.build" and s.ms >= 1.0


def test_stream_report_of_a_traced_run(engine):
    tracing.enable()
    list(engine.run(frames(4)))
    report = profile.stream_report(tracing.collected(), tracing.counters(), 4)
    assert set(report["span_ms_per_frame"]) == {"engine.stage", "engine.slot_wait", "engine.encode", "engine.h2d",
                                                "engine.await_staged", "engine.replay", "engine.consumer"}
    assert report["counters"]["engine.dispatched"] == 4
    assert 0 <= report["await_blocked_share"] <= 1
    assert report["idle_gaps"] == [] and report["frame_gap_ms"] is None and report["seconds"] == []


def test_request_report_sums_a_request_s_spans(engine):
    tracing.enable()
    for f in frames(3):
        engine(*f)
    list(engine.run(frames(2)))  # no request: left out
    report = profile.request_report(tracing.collected())
    assert set(report) == {"engine.request", "engine.stage", "engine.slot_wait", "engine.encode", "engine.h2d",
                           "engine.replay"}
    assert report["engine.encode"] <= report["engine.stage"] <= report["engine.request"]


def test_request_counts_give_each_counter_a_request(engine):
    tracing.enable()
    for f in frames(3):
        engine(*f)
    counts = profile.request_counts(tracing.collected(), tracing.counters())
    assert counts == {"engine.dispatched": 1.0, "engine.encode_parallel": 1.0}
    assert profile.request_counts([], {"engine.dispatched": 2}) == {}


def test_stream_report_of_device_frames():
    spans = [span("device.frame", 0, 400_000_000, None), span("device.frame", 500_000_000, 900_000_000, None),
             span("device.frame", 1_000_000_000, 1_500_000_000, None),
             span("engine.await_staged", 350_000_000, 1_100_000_000),
             span("engine.replay", 950_000_000, 1_050_000_000)]
    report = profile.stream_report(spans, {"engine.dispatched": 3, "engine.await_blocked": 1}, 3)
    assert report["await_blocked_share"] == pytest.approx(1 / 3)
    assert report["frame_gap_ms"] == pytest.approx(100.0)
    assert report["idle_named_share"] == 1.0 and report["idle_await_staged_share"] == pytest.approx(1.0)
    assert [sec["device_frames"] for sec in report["seconds"]] == [2, 1]
    assert report["seconds"][1]["ms"]["device.frame"] == pytest.approx(500.0)


def test_the_chrome_trace_gains_the_tracer_s_spans(tmp_path):
    worker = threading.Thread(target=lambda: tracing.span("engine.stage", 3).__enter__().__exit__(None, None, None))
    with profile._profiler_all_threads() as prof:
        with tracing.span("engine.await_staged", 3):
            worker.start()
            worker.join(timeout=10)
    device = span("device.frame", time.perf_counter_ns(), time.perf_counter_ns() + 1000, None, 3)
    path = tmp_path / "t.json"
    profile.write_chrome(prof, str(path), tracing.collected() + [device])
    trace = json.loads(path.read_text())
    events = {e["name"]: e for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert {"engine.stage", "engine.await_staged", "device.frame"} <= set(events)
    assert events["engine.stage"]["tid"] != events["engine.await_staged"]["tid"]
    merged = [e for e in trace["traceEvents"] if e.get("pid") == "tracer"]
    assert [e["name"] for e in merged] == ["device.frame"] and merged[0]["args"]["frame"] == 3
    stage = events["engine.stage"]
    assert abs(merged[0]["ts"] - stage["ts"]) < 10e6
