"""Serving runtime of the port: the streaming engine, benchmarking, and the
``torch.export`` program of the deployed forward. The wire encoders are the
C ones the engine runs (:mod:`..data.native`); :mod:`.wires` holds their
plain numpy versions."""
from ..data.native import encode_depth_coo, encode_depth_wire, encode_yuv420, encode_yuv422
from .export import export_guided, load_exported, save_exported
from .streaming import FrameStats, StreamingEngine, benchmark, benchmark_throughput

__all__ = [
    "FrameStats", "StreamingEngine", "benchmark", "benchmark_throughput", "encode_depth_coo",
    "encode_depth_wire", "encode_yuv420", "encode_yuv422", "export_guided", "load_exported", "save_exported",
]
