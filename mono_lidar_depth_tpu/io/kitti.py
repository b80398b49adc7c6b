"""KITTI odometry dataset access.

Replaces the reference's ROS-side data plumbing (rosbag playback +
message_filters sync, tracklets_depth_ros_tool/launch/tracklets.launch):
KITTI frames are aligned by index, so "synchronization" is array
indexing.  Velodyne scans stream through the native C++ prefetching
reader (native/kitti_reader.cpp) with a numpy fallback.

Expected layout (standard KITTI odometry):
    <root>/sequences/<seq>/velodyne/000000.bin ...
    <root>/sequences/<seq>/image_0/000000.png ...     (optional)
    <root>/sequences/<seq>/calib.txt
    <root>/sequences/<seq>/times.txt
    <root>/poses/<seq>.txt                            (optional GT)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..core.geometry import SE3, PinholeCamera
from . import native as _native
from .png import read_png


def read_velodyne(path: str, max_points: Optional[int] = None
                  ) -> tuple[np.ndarray, int]:
    """Read a velodyne .bin → ([max_points or n, 4] float32, n)."""
    if max_points is not None and _native.native_available():
        return _native.read_velodyne_native(path, max_points)
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    n = len(raw)
    if max_points is None:
        return raw, n
    out = np.zeros((max_points, 4), dtype=np.float32)
    out[:min(n, max_points)] = raw[:max_points]
    return out, min(n, max_points)


def pad_cloud(xyzi: np.ndarray, n: int, max_points: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """([*, 4], count) → (padded [max_points, 3] xyz, valid mask)."""
    out = np.zeros((max_points, 3), dtype=np.float32)
    k = min(n, max_points)
    out[:k] = xyzi[:k, :3]
    valid = np.zeros(max_points, dtype=bool)
    valid[:k] = True
    return out, valid


@dataclass(frozen=True)
class KittiCalib:
    """Per-sequence calibration: grayscale-left projection + lidar→cam."""

    camera: PinholeCamera
    lidar_to_cam: SE3  # velodyne frame → cam0 frame

    @classmethod
    def from_file(cls, path: str, image_width: int = 1226,
                  image_height: int = 370) -> "KittiCalib":
        """Parse a KITTI odometry calib.txt (P0..P3 + Tr lines)."""
        import jax.numpy as jnp

        mats = {}
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, vals = line.split(":", 1)
                mats[key.strip()] = np.array(
                    [float(v) for v in vals.split()], dtype=np.float64)
        P0 = mats["P0"].reshape(3, 4)
        Tr = mats["Tr"].reshape(3, 4)
        f_len = float(P0[0, 0])
        cx, cy = float(P0[0, 2]), float(P0[1, 2])
        cam = PinholeCamera(width=image_width, height=image_height,
                            focal_length=f_len, cx=cx, cy=cy)
        T = SE3(jnp.asarray(Tr[:, :3], dtype=jnp.float32),
                jnp.asarray(Tr[:, 3], dtype=jnp.float32))
        return cls(camera=cam, lidar_to_cam=T)


class KittiSequence:
    """One KITTI odometry sequence."""

    def __init__(self, root: str, sequence: str,
                 image_width: int = 1226, image_height: int = 370):
        self.root = Path(root)
        self.sequence = sequence
        seq_dir = self.root / "sequences" / sequence
        if not seq_dir.exists():
            raise FileNotFoundError(seq_dir)
        self.seq_dir = seq_dir
        self.velodyne_dir = seq_dir / "velodyne"
        self.image_dir = seq_dir / "image_0"
        self.calib = KittiCalib.from_file(
            str(seq_dir / "calib.txt"), image_width, image_height)
        times_file = seq_dir / "times.txt"
        self.times = (np.loadtxt(times_file, dtype=np.float64)
                      if times_file.exists() else None)
        self.scan_paths = sorted(
            str(p) for p in self.velodyne_dir.glob("*.bin")
        ) if self.velodyne_dir.exists() else []
        poses_file = self.root / "poses" / f"{sequence}.txt"
        self.gt_poses = (self._load_poses(poses_file)
                         if poses_file.exists() else None)

    @staticmethod
    def _load_poses(path: Path) -> np.ndarray:
        """[F, 4, 4] cam0 poses (world ← cam)."""
        raw = np.loadtxt(path).reshape(-1, 3, 4)
        out = np.tile(np.eye(4), (len(raw), 1, 1))
        out[:, :3, :] = raw
        return out

    def __len__(self) -> int:
        return len(self.scan_paths)

    def scans(self, max_points: int, prefetch: int = 4,
              threads: int = 2) -> Iterator[tuple[np.ndarray, int]]:
        """Iterate padded scans ([max_points, 4], count) in order,
        prefetched by the native reader when available."""
        if _native.native_available() and self.scan_paths:
            yield from _native.NativeScanLoader(
                self.scan_paths, max_points, depth=prefetch, threads=threads)
        else:
            for p in self.scan_paths:
                yield read_velodyne(p, max_points)

    def image(self, index: int) -> Optional[np.ndarray]:
        """Grayscale image as [H, W] uint8, or None if absent."""
        p = self.image_dir / f"{index:06d}.png"
        if not p.exists():
            return None
        return read_png(p)

    def semantic(self, index: int) -> Optional[np.ndarray]:
        """Semantic label image as [H, W] uint8, or None if the sequence
        has no semantics (real KITTI odometry ships none; the reference's
        4-way-sync path consumes an external segmentation stream —
        tracklet_depth_interface.cpp:61-99)."""
        p = self.seq_dir / "semantic_0" / f"{index:06d}.png"
        if not p.exists():
            return None
        return read_png(p)


def make_synthetic_scan(rng: np.random.Generator, n_points: int = 120000,
                        ) -> np.ndarray:
    """KITTI-like synthetic velodyne scan (lidar frame, z up): ground
    plane + walls + scattered structure.  Used by benchmarks and tests
    when the real dataset is absent."""
    n_ground = n_points // 2
    n_wall = n_points // 4
    n_clutter = n_points - n_ground - n_wall
    r = rng.uniform(2, 70, n_ground)
    th = rng.uniform(-np.pi / 3, np.pi / 3, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       -1.73 + 0.02 * rng.normal(size=n_ground)], 1)
    wx = rng.uniform(14.5, 15.5, n_wall)
    wy = rng.uniform(-12, 12, n_wall)
    wz = rng.uniform(-1.7, 2.5, n_wall)
    wall = np.stack([wx, wy, wz], 1)
    clutter = rng.uniform([2, -20, -1.7], [75, 20, 4], (n_clutter, 3))
    pts = np.concatenate([ground, wall, clutter]).astype(np.float32)
    intens = rng.uniform(0, 1, (n_points, 1)).astype(np.float32)
    return np.concatenate([pts, intens], axis=1)
