"""The voxel grid of the 3D video path, in numpy on the host.

Port of `posecnn_tpu/utils/voxelizer.py` (`Voxelizer`, lib/utils/
voxelizer.py): the grid fitted to a point cloud with a margin, its six
meta_data floats [42:48] (the step, then the minimum corner), and depth
lifted to camera- or world-frame points in float64.
"""

from __future__ import annotations

import numpy as np


class Voxelizer:
    def __init__(self, grid_size: int = 256, margin: float = 0.1):
        self.grid_size = grid_size
        self.margin = margin
        self.voxelized = False
        self.min_x = self.min_y = self.min_z = 0.0
        self.max_x = self.max_y = self.max_z = 0.0
        self.step_x = self.step_y = self.step_z = 0.0

    def setup(self, min_x, min_y, min_z, max_x, max_y, max_z):
        self.min_x, self.min_y, self.min_z = min_x, min_y, min_z
        self.max_x, self.max_y, self.max_z = max_x, max_y, max_z
        self.step_x = (max_x - min_x) / self.grid_size
        self.step_y = (max_y - min_y) / self.grid_size
        self.step_z = (max_z - min_z) / self.grid_size
        self.voxelized = True

    def voxelize(self, points: np.ndarray):
        """Fit the grid once to the finite points (N,3), `margin` beyond
        their extremes; later calls keep it."""
        if self.voxelized:
            return
        valid = points[np.isfinite(points).all(axis=-1)]
        mins = valid.min(axis=0) - self.margin
        maxs = valid.max(axis=0) + self.margin
        self.setup(mins[0], mins[1], mins[2], maxs[0], maxs[1], maxs[2])

    def meta_fields(self) -> np.ndarray:
        """meta_data[42:48]: the step, then the minimum corner, float32."""
        return np.array([self.step_x, self.step_y, self.step_z, self.min_x, self.min_y, self.min_z], dtype=np.float32)

    @staticmethod
    def backproject_camera(im_depth: np.ndarray, intrinsic_matrix: np.ndarray, factor_depth: float = 1.0) -> np.ndarray:
        """Depth (H,W) -> camera-frame points (3, H*W), float64."""
        depth = im_depth.astype(np.float64) / factor_depth
        Kinv = np.linalg.inv(np.asarray(intrinsic_matrix, dtype=np.float64))
        height, width = depth.shape
        x, y = np.meshgrid(np.arange(width), np.arange(height))
        ones = np.ones((height, width), dtype=np.float64)
        x2d = np.stack((x, y, ones), axis=2).reshape(width * height, 3)
        R = Kinv @ x2d.transpose()
        return np.multiply(np.tile(depth.reshape(1, width * height), (3, 1)), R)

    def backproject_world(self, im_depth, intrinsic_matrix, RT_camera2world, factor_depth: float = 1.0):
        """Depth -> world-frame points (3, H*W) through [R|t] camera2world."""
        X = self.backproject_camera(im_depth, intrinsic_matrix, factor_depth)
        return RT_camera2world[:, :3] @ X + RT_camera2world[:, 3].reshape(3, 1)
