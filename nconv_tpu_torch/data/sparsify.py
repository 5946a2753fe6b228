"""Sparse-input synthesis and depth preprocessing on the host (the JAX
package's ``data/sparsify.py``, numpy and ``scipy.ndimage``, the mask's
multiply in :mod:`.native`):

  * mask-pool sparsification, off-size masks resized by nearest neighbour
    with PIL's index rule;
  * random point dropping matched to a mask's zero count;
  * multiplicative +-10% noise on 10% of the points;
  * VOID edge inpainting: Sobel magnitude > 0.5, then 5 rounds of
    dilation-based nearest fill.

Every function takes an explicit ``rng``; for the same generator state each
draws what the JAX package's function draws, in the same order.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve, grey_dilation

from . import native

# cv2 MORPH_ELLIPSE (3,3): a 3x3 cross.
_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index of each output position: the centre
    n_in / n_out * 0.5 stepped by n_in / n_out, accumulated in float64 as
    PIL's loop adds it, truncated."""
    scale = n_in / n_out
    steps = np.full(n_out, scale)
    steps[0] = scale * 0.5
    return np.minimum(np.add.accumulate(steps).astype(np.int64), n_in - 1)


def resize_mask_nearest(mask: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of a 2-D mask to ``shape``, pixel for pixel
    what PIL's ``Image.resize(..., NEAREST)`` gives."""
    if mask.shape == shape:
        return mask
    rows = _nearest_index(mask.shape[0], shape[0])
    cols = _nearest_index(mask.shape[1], shape[1])
    return mask[rows[:, None], cols[None, :]]


def apply_mask_pool(
    depth: np.ndarray, masks: list[np.ndarray] | np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Multiply float32 ``depth`` by a random mask from the pool (resized if
    needed), into a fresh array (:func:`.native.apply_mask`)."""
    if isinstance(masks, list):
        mask = masks[rng.integers(len(masks))]
    else:
        mask = masks
    mask = resize_mask_nearest(mask, depth.shape[-2:])
    return native.apply_mask(depth, mask)


def drop_random_points(
    depth: np.ndarray, n_zeros: int, rng: np.random.Generator
) -> np.ndarray:
    """Zero ``n_zeros`` random positions (the use_mask=False branch)."""
    flat = depth.reshape(-1).copy()
    n = min(n_zeros, flat.size)
    idx = rng.permutation(flat.size)[:n]
    flat[idx] = 0
    return flat.reshape(depth.shape)


def add_multiplicative_noise(
    depth: np.ndarray,
    rng: np.random.Generator,
    *,
    fraction: float = 0.1,
    amplitude: float = 0.1,
) -> np.ndarray:
    """x += x * U(-amp, amp) on a random ``fraction`` of points."""
    flat = depth.reshape(-1).copy()
    n = int(flat.size * fraction)
    idx = rng.permutation(flat.size)[:n]
    noise = rng.uniform(-amplitude, amplitude, n).astype(flat.dtype)
    flat[idx] += flat[idx] * noise
    return flat.reshape(depth.shape)


def sobel_edge_map(depth: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Binary edge map from the Sobel gradient magnitude (zero-padded
    convolutions, as the reference's F.conv2d(padding=1))."""
    d = np.asarray(depth, np.float32)
    gx = convolve(d, SOBEL_X[::-1, ::-1], mode="constant")
    gy = convolve(d, SOBEL_Y[::-1, ::-1], mode="constant")
    mag = np.sqrt(gx * gx + gy * gy)
    return (mag > threshold).astype(np.float32)


def inpaint_with_nearest(
    depth: np.ndarray, mask: np.ndarray, iterations: int = 5
) -> np.ndarray:
    """Dilation-based nearest fill of masked pixels: each round replaces
    them with the 3x3-cross grey dilation."""
    out = np.asarray(depth, np.float32).copy()
    hole = mask > 0
    for _ in range(iterations):
        dilated = grey_dilation(out, footprint=_CROSS, mode="nearest")
        out[hole] = dilated[hole]
    return out


def edge_inpaint(depth: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """VOID edge inpainting: detect Sobel edges, refill them from their
    neighbours (applied to both the sparse input and the GT)."""
    edges = sobel_edge_map(depth, threshold)
    return inpaint_with_nearest(depth, edges)
