"""Kernels: the unit's least time (benchmark/work.py) over its device busy time, %."""
from benchmark import trace


def read(traced):
    return trace.roofline(traced)
