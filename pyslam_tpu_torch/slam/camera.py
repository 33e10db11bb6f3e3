"""Camera models (reference: pySLAM ``pyslam/slam/camera.py``).

``PinholeCamera`` carries intrinsics, distortion, stereo baseline (bf) and the
depth thresholds the tracking front-end uses.  Host numpy code, ported from
``pyslam_tpu/slam/camera.py``; undistortion is not ported yet (the slice's
streams are rectified), so a camera with distortion coefficients raises.
"""

from __future__ import annotations

import enum

import numpy as np


class CameraType(enum.Enum):
    PINHOLE = 0


class Camera:
    def __init__(self, width, height, fx, fy, cx, cy):
        self.width = int(width)
        self.height = int(height)
        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float64
        )


class PinholeCamera(Camera):
    def __init__(
        self,
        width,
        height,
        fx,
        fy,
        cx,
        cy,
        D=None,
        fps: float = 30.0,
        bf: float = 0.0,
        depth_factor: float = 1.0,
        depth_threshold: float | None = None,
    ):
        super().__init__(width, height, fx, fy, cx, cy)
        self.type = CameraType.PINHOLE
        self.D = np.zeros(5) if D is None else np.asarray(D, np.float64).reshape(-1)[:5]
        if len(self.D) < 5:
            self.D = np.pad(self.D, (0, 5 - len(self.D)))
        self.fps = fps
        self.bf = float(bf)
        self.b = self.bf / self.fx if self.fx else 0.0
        self.depth_factor = depth_factor
        # close/far point threshold: bf * th / fx (ORB-SLAM ThDepth semantics)
        self.depth_threshold = (
            depth_threshold if depth_threshold is not None else (40.0 * self.b if bf else np.inf)
        )
        self.is_distorted = bool(np.any(self.D != 0.0))
        if self.is_distorted:
            raise NotImplementedError("lens undistortion is not ported yet")
        self.u_min, self.u_max = 0.0, float(width)
        self.v_min, self.v_max = 0.0, float(height)

    def unproject_points(self, uv):
        """Pixels -> normalized coords on z=1 plane (undistorted input)."""
        uv = np.asarray(uv, np.float32)
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return np.stack([x, y], axis=-1)

    def backproject_points(self, uv, depth):
        uv = np.asarray(uv, np.float32)
        depth = np.asarray(depth, np.float32)
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return np.stack([x * depth, y * depth, depth], axis=-1)
