"""Camera models (reference: pySLAM ``pyslam/slam/camera.py``).

``PinholeCamera`` carries intrinsics, distortion, stereo baseline (bf) and the
depth thresholds the tracking front-end uses.  Host numpy code, ported from
``pyslam_tpu/slam/camera.py``.  A camera with distortion coefficients
undistorts pixels with ``ops.geometry.undistort_pixels`` (float32, on the
CPU or on the device of the tensor it is given) and bounds the undistorted
image by its undistorted corners, which the projection searches read.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from pyslam_tpu_torch.ops import geometry


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
        self.u_min, self.u_max = 0.0, float(width)
        self.v_min, self.v_max = 0.0, float(height)
        if self.is_distorted:
            self._init_undistorted_bounds()

    def _init_undistorted_bounds(self):
        corners = np.array([[0, 0], [self.width, 0], [0, self.height],
                            [self.width, self.height]], np.float64)
        und = self.undistort_points(corners)
        self.u_min = float(min(und[0, 0], und[2, 0]))
        self.u_max = float(max(und[1, 0], und[3, 0]))
        self.v_min = float(min(und[0, 1], und[1, 1]))
        self.v_max = float(max(und[2, 1], und[3, 1]))

    def undistort_points(self, uv):
        """Distorted pixels -> undistorted pixels (float32).  A tensor is
        undistorted on its own device and returned as a tensor; anything
        else on the CPU, returned as numpy."""
        if isinstance(uv, torch.Tensor):
            if not self.is_distorted:
                return uv.to(torch.float32)
            dev = uv.device
            return geometry.undistort_pixels(
                uv.to(torch.float32), torch.as_tensor(self.K, dtype=torch.float32).to(dev),
                torch.as_tensor(self.D, dtype=torch.float32).to(dev))
        if not self.is_distorted:
            return np.asarray(uv, np.float32)
        return self.undistort_points(torch.as_tensor(np.asarray(uv, np.float32))).numpy()

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

    def to_json(self):
        return {
            "width": self.width,
            "height": self.height,
            "fx": self.fx,
            "fy": self.fy,
            "cx": self.cx,
            "cy": self.cy,
            "D": self.D.tolist(),
            "fps": self.fps,
            "bf": self.bf,
            "depth_factor": self.depth_factor,
            "depth_threshold": float(self.depth_threshold),
        }

    @staticmethod
    def from_json(d: dict) -> "PinholeCamera":
        return PinholeCamera(
            d["width"], d["height"], d["fx"], d["fy"], d["cx"], d["cy"],
            D=d.get("D"), fps=d.get("fps", 30.0), bf=d.get("bf", 0.0),
            depth_factor=d.get("depth_factor", 1.0),
            depth_threshold=d.get("depth_threshold"),
        )
