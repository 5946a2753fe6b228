"""Serving runtime of the port."""
from .streaming import FrameStats, StreamingEngine, benchmark, encode_depth_wire

__all__ = ["FrameStats", "StreamingEngine", "benchmark", "encode_depth_wire"]
