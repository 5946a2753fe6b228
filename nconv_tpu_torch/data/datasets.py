"""Dataset readers: NYUv2, KITTI depth completion, VOID-1500 (the JAX
package's ``data/datasets.py``, on the port's :mod:`.io` and
:mod:`.sparsify`).

Indexable, stateless readers returning dicts of numpy NHWC-layout arrays
(``rgb`` (H,W,3) BGR 0..255, ``depth``/``gt`` (H,W,1), ``k`` (3,3),
optionally ``pose``), with the reference's on-disk layouts and crops:

  * the crop is top-aligned in rows, centred in columns, and the principal
    point shifts with it;
  * NYU synthesizes its sparse input from the GT through the mask pool
    (``sparse_source="lidar"`` reads the real lidar files instead);
  * KITTI globs the annotated / velodyne trees and rebuilds the raw-RGB
    path and the drive's calibration from each GT path;
  * VOID reads manifest files and edge-inpaints.

A dataset draws its sparsification from one generator seeded at
construction, so item ``i`` depends on the items read before it, as in the
JAX package.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np

from . import io, native, sparsify

# NYU fixed intrinsics (nyuloader.py:29 / :138)
NYU_K = np.array(
    [[582.62448, 0.0, 313.04476], [0.0, 582.69103, 238.44390], [0.0, 0.0, 1.0]],
    np.float32,
)
NYU_TEST_K = np.array(
    [[329.64, 0.0, 318.0], [0.0, 328.62, 236.0], [0.0, 0.0, 1.0]], np.float32
)


def crop_top_center(arrs, k, height, width):
    """Top-aligned row crop, centered col crop, shift principal point; the
    crops are fresh float32 arrays (:func:`.native.crop_top_center`)."""
    h_in, w_in = arrs[0].shape[:2]
    tp = h_in - height
    lp = (w_in - width) // 2
    out = [native.crop_top_center(a, height, width) for a in arrs]
    k = k.copy()
    k[0, 2] -= lp
    k[1, 2] -= tp
    return out, k


def _hw1(x: np.ndarray) -> np.ndarray:
    return x[:, :, None] if x.ndim == 2 else x


@dataclass
class NYUDataset:
    """NYUv2 layout: ``<root>/<mode>/{gt,depth,img}`` + ``<root>/mask``
    (`nyuloader.py:10-29`)."""

    root: str
    mode: str = "train"
    use_mask: bool = True
    add_noise: bool = False
    height: int = 480
    width: int = 640
    sparse_source: str = "gt"  # 'gt' (reference behaviour) | 'lidar'
    seed: int = 0

    def __post_init__(self):
        j = os.path.join
        self.gt_files = sorted(glob.glob(j(self.root, self.mode, "gt", "*.npy")))
        self.lidar_files = sorted(glob.glob(j(self.root, self.mode, "depth", "*.npy")))
        self.rgb_files = sorted(glob.glob(j(self.root, self.mode, "img", "*.png")))
        self.mask_files = sorted(glob.glob(j(self.root, "mask", "*.npy")))
        self._masks = [np.load(p) for p in self.mask_files]
        self._rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.gt_files)

    def __getitem__(self, index: int) -> dict:
        rgb = io.load_rgb(self.rgb_files[index])
        gt = io.load_npy_depth(self.gt_files[index], (480, 640))
        if self.sparse_source == "lidar" and self.lidar_files:
            base = io.load_npy_depth(self.lidar_files[index], (480, 640))
        else:
            base = gt.copy()

        (rgb, gt_c), k = crop_top_center([rgb, gt], NYU_K, self.height, self.width)

        depth = base
        if self.add_noise:
            depth = sparsify.add_multiplicative_noise(depth, self._rng)
        if self.use_mask and self._masks:
            depth = sparsify.apply_mask_pool(depth, self._masks, self._rng)
        elif self._masks:
            mask = self._masks[self._rng.integers(len(self._masks))]
            depth = sparsify.drop_random_points(
                depth, int(np.count_nonzero(mask == 0)), self._rng
            )
        # note: like the reference (nyuloader.py:57), the sparse input is
        # built from the *uncropped* full frame
        return {
            "rgb": rgb,
            "depth": _hw1(depth.astype(np.float32)),
            "gt": _hw1(gt_c.astype(np.float32)),
            "k": k,
        }


@dataclass
class NYUTestDataset:
    """NYU test split: rgb + sparse depth only, no crop, fixed test
    intrinsics (`nyuloader.py:126-170`)."""

    root: str
    mode: str = "test"

    def __post_init__(self):
        j = os.path.join
        self.lidar_files = sorted(glob.glob(j(self.root, self.mode, "depth", "*.npy")))
        self.rgb_files = sorted(glob.glob(j(self.root, self.mode, "img", "*.png")))

    def __len__(self):
        return len(self.lidar_files)

    def __getitem__(self, index: int) -> dict:
        rgb = io.load_rgb(self.rgb_files[index])
        depth = io.load_npy_depth(self.lidar_files[index], (480, 640))
        return {
            "rgb": rgb,
            "depth": _hw1(depth.astype(np.float32)),
            "k": NYU_TEST_K.copy(),
        }


@dataclass
class KITTIDataset:
    """KITTI depth completion train/val: ``data_depth_annotated`` +
    ``data_depth_velodyne`` + ``raw`` RGB (`kittiloader.py:25-94`)."""

    root: str
    mode: str = "train"
    height: int = 256
    width: int = 1216

    def __post_init__(self):
        j = os.path.join
        self.gt_files = sorted(
            glob.glob(j(self.root, "data_depth_annotated", self.mode, "**", "*.png"), recursive=True)
        )
        self.lidar_files = sorted(
            glob.glob(j(self.root, "data_depth_velodyne", self.mode, "**", "*.png"), recursive=True)
        )

    def __len__(self):
        return len(self.gt_files)

    def rgb_path(self, gt_path: str) -> str:
        parts = gt_path.split(os.sep)
        drive = parts[-5]
        day = drive.split("_drive")[0]
        return os.sep.join(
            parts[:-7] + ["raw", day, drive, parts[-2], "data", parts[-1]]
        )

    def calib_path(self, gt_path: str) -> str:
        parts = gt_path.split(os.sep)
        day = parts[-5].split("_drive")[0]
        return os.sep.join(parts[:-7] + ["raw", day, "calib_cam_to_cam.txt"])

    def __getitem__(self, index: int) -> dict:
        gt_path = self.gt_files[index]
        rgb = io.load_rgb(self.rgb_path(gt_path))
        depth = io.load_depth_png16(self.lidar_files[index])
        gt = io.load_depth_png16(gt_path)
        camera = gt_path.split(os.sep)[-2]
        k = io.kitti_intrinsics(io.read_calib_file(self.calib_path(gt_path)), camera)
        (rgb, depth, gt), k = crop_top_center(
            [rgb, depth, gt], k, self.height, self.width
        )
        return {
            "rgb": rgb,
            "depth": _hw1(depth),
            "gt": _hw1(gt),
            "k": k,
        }


@dataclass
class KITTISelValDataset:
    """``val_selection_cropped`` with per-image intrinsics
    (`kittiloader.py:97-157`)."""

    root: str
    height: int = 256
    width: int = 1216

    def __post_init__(self):
        j = os.path.join
        base = j(self.root, "val_selection_cropped")
        self.gt_files = sorted(glob.glob(j(base, "groundtruth_depth", "*.png")))
        self.lidar_files = sorted(glob.glob(j(base, "velodyne_raw", "*.png")))
        self.rgb_files = sorted(glob.glob(j(base, "image", "*.png")))

    def __len__(self):
        return len(self.gt_files)

    def __getitem__(self, index: int) -> dict:
        rgb = io.load_rgb(self.rgb_files[index])
        depth = io.load_depth_png16(self.lidar_files[index])
        gt = io.load_depth_png16(self.gt_files[index])
        parts = self.rgb_files[index].split(os.sep)
        intr = os.sep.join(parts[:-2] + ["intrinsics", parts[-1][:-3] + "txt"])
        with open(intr) as f:
            k = np.array(f.read().split(), np.float32).reshape(3, 3)
        (rgb, depth, gt), k = crop_top_center(
            [rgb, depth, gt], k, self.height, self.width
        )
        return {"rgb": rgb, "depth": _hw1(depth), "gt": _hw1(gt), "k": k}


@dataclass
class KITTITestDataset:
    """``test_depth_completion_anonymous`` (no GT), 352x1216
    (`kittiloader.py:160-211`)."""

    root: str
    height: int = 352
    width: int = 1216

    def __post_init__(self):
        j = os.path.join
        base = j(self.root, "test_depth_completion_anonymous")
        self.lidar_files = sorted(glob.glob(j(base, "velodyne_raw", "*.png")))
        self.rgb_files = sorted(glob.glob(j(base, "image", "*.png")))

    def __len__(self):
        return len(self.lidar_files)

    def __getitem__(self, index: int) -> dict:
        rgb = io.load_rgb(self.rgb_files[index])
        depth = io.load_depth_png16(self.lidar_files[index])
        parts = self.rgb_files[index].split(os.sep)
        intr = os.sep.join(parts[:-2] + ["intrinsics", parts[-1][:-3] + "txt"])
        with open(intr) as f:
            k = np.array(f.read().split(), np.float32).reshape(3, 3)
        (rgb, depth), k = crop_top_center([rgb, depth], k, self.height, self.width)
        return {"rgb": rgb, "depth": _hw1(depth), "k": k}


@dataclass
class VOIDDataset:
    """VOID-1500: manifest-driven, 16-bit PNG depth, per-frame pose + K,
    edge-inpainted GT (`voidloader.py:16-160`)."""

    root: str
    mode: str = "train"
    use_mask: bool = True
    edge_inpainting: bool = True
    seed: int = 0

    def __post_init__(self):
        j = os.path.join
        base = j(self.root, "void_1500")
        p = lambda name: j(base, f"{self.mode}_{name}.txt")
        self.pose_files = io.read_paths(self.root, p("absolute_pose"))
        self.gt_files = io.read_paths(self.root, p("ground_truth"))
        self.rgb_files = io.read_paths(self.root, p("image"))
        self.k_files = io.read_paths(self.root, p("intrinsics"))
        self.sparse_files = io.read_paths(self.root, p("sparse_depth"))
        self.mask_files = sorted(glob.glob(j(base, "mask", "*.npy")))
        self._masks = [np.load(m) for m in self.mask_files]
        self._rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.gt_files)

    def __getitem__(self, index: int) -> dict:
        rgb = io.load_rgb(self.rgb_files[index])
        gt = io.load_depth_png16(self.gt_files[index])
        pose = np.loadtxt(self.pose_files[index]).astype(np.float32)
        k = np.loadtxt(self.k_files[index]).astype(np.float32)

        # sparse input from GT (use_mask) or the real sparse files
        # (voidloader.py:59-66); both edge-inpainted
        src = gt if self.use_mask else io.load_depth_png16(self.sparse_files[index])
        depth = sparsify.edge_inpaint(src) if self.edge_inpainting else src.copy()
        if self.use_mask and self._masks:
            depth = sparsify.apply_mask_pool(depth, self._masks, self._rng)
        gt_out = sparsify.edge_inpaint(gt) if self.edge_inpainting else gt

        return {
            "rgb": rgb,
            "depth": _hw1(depth.astype(np.float32)),
            "gt": _hw1(gt_out.astype(np.float32)),
            "k": k,
            "pose": pose,
        }
