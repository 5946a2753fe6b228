"""Data of the port: the dataset readers (NYU, KITTI, VOID) on its own PNG
codec, the sparsifiers, batching, device staging and a synthetic dataset
(numpy and scipy only, no JAX, no PIL)."""
from . import io, png, sparsify
from .datasets import (
    NYU_K,
    NYU_TEST_K,
    KITTIDataset,
    KITTISelValDataset,
    KITTITestDataset,
    NYUDataset,
    NYUTestDataset,
    VOIDDataset,
    crop_top_center,
)
from .pipeline import Loader, collate, prefetch_to_device
from .synthetic import SyntheticDataset, bench_batch

__all__ = [
    "io", "png", "sparsify", "NYU_K", "NYU_TEST_K", "KITTIDataset", "KITTISelValDataset",
    "KITTITestDataset", "NYUDataset", "NYUTestDataset", "VOIDDataset", "crop_top_center",
    "Loader", "SyntheticDataset", "bench_batch", "collate", "prefetch_to_device",
]
