"""Homography-based pixel -> world calibration
(reference ``foresight_rospkg/src/utils/camera_calib/calibrated_camera.py``).

Fit a plane homography from >= 4 (pixel, world-xy) correspondences; map
designated pixels to workspace coordinates for scripted policies.

The port's copy of ``visual_foresight_tpu/sim/util/camera_calib.py``.
"""

import numpy as np


class CalibratedCamera:
    def __init__(self, pixel_points, world_points):
        """
        :param pixel_points: (N, 2) [row, col]
        :param world_points: (N, 2) workspace [x, y] at the table plane
        """
        pixel_points = np.asarray(pixel_points, np.float64)
        world_points = np.asarray(world_points, np.float64)
        assert pixel_points.shape[0] >= 4, 'need at least 4 correspondences'
        self._H = self._fit_homography(pixel_points, world_points)
        self._H_inv = np.linalg.inv(self._H)

    @staticmethod
    def _fit_homography(src, dst):
        """DLT homography src(pixel) -> dst(world)."""
        n = src.shape[0]
        A = np.zeros((2 * n, 9))
        for i in range(n):
            r, c = src[i]
            x, y = dst[i]
            A[2 * i] = [r, c, 1, 0, 0, 0, -x * r, -x * c, -x]
            A[2 * i + 1] = [0, 0, 0, r, c, 1, -y * r, -y * c, -y]
        _, _, vt = np.linalg.svd(A)
        H = vt[-1].reshape(3, 3)
        return H / H[2, 2]

    def _apply(self, H, points):
        points = np.atleast_2d(np.asarray(points, np.float64))
        homo = np.concatenate([points, np.ones((points.shape[0], 1))], axis=1)
        out = homo @ H.T
        return out[:, :2] / out[:, 2:3]

    def pixel_to_world(self, pixels):
        """(N, 2) [row, col] -> (N, 2) world [x, y]."""
        return self._apply(self._H, pixels)

    def world_to_pixel(self, world_xy):
        return self._apply(self._H_inv, world_xy)
