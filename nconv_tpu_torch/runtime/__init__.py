"""Serving runtime of the port: the streaming engine, benchmarking, and the
``torch.export`` program of the deployed forward."""
from .export import export_guided, load_exported, save_exported
from .streaming import FrameStats, StreamingEngine, benchmark, benchmark_throughput
from .wires import encode_depth_coo, encode_depth_wire, encode_yuv420, encode_yuv422

__all__ = [
    "FrameStats", "StreamingEngine", "benchmark", "benchmark_throughput", "encode_depth_coo",
    "encode_depth_wire", "encode_yuv420", "encode_yuv422", "export_guided", "load_exported", "save_exported",
]
