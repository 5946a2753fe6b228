"""Data for the port's training: batching, device staging and a synthetic
dataset (numpy only, no JAX)."""
from .pipeline import Loader, collate, prefetch_to_device
from .synthetic import SyntheticDataset, bench_batch

__all__ = ["Loader", "SyntheticDataset", "bench_batch", "collate", "prefetch_to_device"]
