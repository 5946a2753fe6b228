"""The per-layer metrics read from the program's tracer
(``benchmark/metrics/{encode_ms.request,h2d_ms.request,
await_staged_ms.stream,frame_gap_ms.stream}.py``): traced CPU runs of the
request and the stream loop, where the host spans read as numbers and the
device intervals (CUDA events) read none; and a program without the
tracer, or with nothing in it, where every reader returns ``None``."""
from __future__ import annotations

import sys
import time

import pytest

from benchmark import spec
from benchmark.run import run_cell
from nconv_tpu_torch.runtime import tracing

SEED = 2**31 + 91
READERS = ("encode_ms.request", "h2d_ms.request", "await_staged_ms.stream", "frame_gap_ms.stream")


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.clear()
    yield
    tracing.clear()


def traced(root, workload):
    return run_cell(spec.load(root, workload), SEED, 0.3, True, "cpu", time.time())


@pytest.mark.parametrize("workload, host, device", [
    ("kitti-mixed-request", "encode_ms.request", "h2d_ms.request"),
    ("kitti-mixed-stream", "await_staged_ms.stream", "frame_gap_ms.stream"),
])
def test_a_traced_run_reads_the_tracer_s_host_spans(tiny_root, workload, host, device):
    result = traced(tiny_root, workload)
    assert result["correct"]
    assert result["metrics"][host]["unit"] == "ms" and result["metrics"][host]["value"] >= 0
    assert device not in result["metrics"]
    assert not tracing.on()  # on only while the slice was profiled


def test_the_request_slice_encodes_each_request_once(tiny_root):
    """One ``engine.encode`` span a request of the profiled slice (both
    streams' wires in one call), and the reader's value their p50."""
    result = traced(tiny_root, "kitti-mixed-request")
    encodes = [s for s in tracing.collected() if s.name == "engine.encode"]
    frames = {s.frame for s in encodes}
    assert len(encodes) == len(frames) == spec.load(tiny_root, "kitti-mixed-request").traffic["trace_units"]
    assert result["metrics"]["encode_ms.request"]["value"] <= max(s.ms for s in encodes)


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_finds_nothing_without_the_tracer(tiny_root, monkeypatch, metric):
    read = spec.load(tiny_root, "kitti-mixed-request").reader(metric)
    assert read(None) is None  # an empty store
    monkeypatch.setitem(sys.modules, "nconv_tpu_torch.runtime.tracing", None)
    monkeypatch.delattr("nconv_tpu_torch.runtime.tracing")
    assert read(None) is None  # the parent's program
