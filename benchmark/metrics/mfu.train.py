"""Whole step: the unit's operations at the peak of their dtypes over the wall time a unit took, %."""
from benchmark import trace


def read(traced):
    return trace.mfu(traced)
