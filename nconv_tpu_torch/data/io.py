"""File IO of the depth-completion datasets (the JAX package's
``data/io.py``, with :mod:`.png` and the C readers of :mod:`.native` in
place of PIL).

  * 16-bit PNG depth with /256 scaling (KITTI, VOID);
  * RGB as float32 in BGR order, 0..255: the reference network was trained
    on raw ``cv2.imread`` output;
  * ``.npy`` depth arrays (NYU);
  * KITTI ``calib_cam_to_cam.txt`` parsing;
  * VOID path-list manifests.
"""
from __future__ import annotations

import os

import numpy as np

from . import native, png


def load_rgb(path: str, *, bgr: bool = True) -> np.ndarray:
    """(H, W, 3) float32, 0..255. BGR by default (reference parity)."""
    return native.load_rgb(path, bgr=bgr)


def load_depth_png16(path: str) -> np.ndarray:
    """(H, W) float32 depth from a greyscale PNG, /256 scaling."""
    return native.load_depth_png16(path, 256.0)


def save_depth_png16(path: str, depth: np.ndarray) -> None:
    arr = np.clip(np.asarray(depth, np.float64) * 256.0, 0, 65535).astype(np.uint16)
    png.write(path, arr)


def load_validity_map_png16(path: str) -> np.ndarray:
    """VOID validity maps: 16-bit PNG, values {0, 256} -> {0, 1}."""
    return (native.load_depth_png16(path) > 0).astype(np.float32)


def load_npy_depth(path: str, shape: tuple[int, int] | None = None) -> np.ndarray:
    d = np.load(path).astype(np.float32)
    if shape is not None:
        d = d.reshape(shape)
    return d


def read_paths(data_dir: str, manifest_path: str) -> list[str]:
    """VOID-style manifest: one relative path per line."""
    out = []
    with open(manifest_path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(os.path.join(data_dir, line))
    return out


def read_calib_file(path: str) -> dict[str, np.ndarray]:
    """KITTI calibration: 'key: floats' lines, non-numeric values skipped."""
    data: dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def kitti_intrinsics(calib: dict[str, np.ndarray], camera: str) -> np.ndarray:
    """K (3x3) for image_02 / image_03 from P_rect_0{2,3}."""
    key = {"image_02": "P_rect_02", "image_03": "P_rect_03"}.get(camera)
    if key is None:
        raise ValueError(f"Unknown camera {camera!r}")
    return np.reshape(calib[key], (3, 4))[0:3, 0:3].astype(np.float32)
