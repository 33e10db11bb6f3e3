"""RGBD visual odometry (port of ``pyslam_tpu/slam/visual_odometry_rgbd.py``).

Per frame: track the previous frame's corners into this one with pyramidal
LK, back-project them with the previous depth map, and solve the relative
pose by motion-only BA of those 3-D points against their tracked pixels
(``optim.pose_optimization``, monocular residuals, ``ur = -1``).  The
metric depth fixes the scale.  Corners come from FAST-9 at threshold 15
with strict 3x3 NMS, which on the card is one launch of the hand kernel
(``ops.fast.fast_nms``, the function the reference's XLA
``fast_score_map`` + ``nms3x3`` computes), and a grid top-k.
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.ops import fast, lk, nms, optim
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.utils.padding import pad_bucket, pad_rows


class VisualOdometryRgbd:
    def __init__(self, camera: PinholeCamera, num_features: int = 600,
                 min_tracked: int = 50, *, device: torch.device | str = "cuda"):
        self.camera = camera
        self.num_features = num_features
        self.min_tracked = min_tracked
        self.device = torch.device(device)
        self._K = torch.as_tensor(camera.K, dtype=torch.float32).to(self.device)
        self.cur_Twc = np.eye(4)
        self.poses = [np.eye(4)]
        self.timestamps = [0.0]
        self.prev_img = None       # device tensor
        self.prev_depth = None     # host array
        self.prev_pts = None
        self.num_tracked = 0

    def _detect(self, img: torch.Tensor) -> np.ndarray:
        score = fast.fast_nms(img[None], 15.0)
        xy, _, valid = nms.grid_topk_keypoints(score, 16, 6, self.num_features)
        return xy[0].cpu().numpy()[valid[0].cpu().numpy()]

    def track(self, img, depth, frame_id: int, timestamp: float = 0.0):
        img_t = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
        depth = np.asarray(depth, np.float32)
        if self.prev_img is None:
            self.prev_img, self.prev_depth = img_t, depth
            self.prev_pts = self._detect(img_t)
            self.timestamps[0] = timestamp
            return self.cur_Twc

        pts0 = self.prev_pts
        if len(pts0) < 10:
            pts0 = self._detect(self.prev_img)
        pts0p, _ = pad_bucket(pts0.astype(np.float32))
        pts1, ok, res = lk.lk_track_pyramidal(self.prev_img, img_t,
                                              torch.as_tensor(pts0p).to(self.device))
        n = len(pts0)
        pts1 = pts1.cpu().numpy()[:n]
        ok = ok.cpu().numpy()[:n] & (res.cpu().numpy()[:n] < 12.0)

        # back-project with the previous depth
        h, w = depth.shape
        xs = np.clip(np.round(pts0[:, 0]).astype(int), 0, w - 1)
        ys = np.clip(np.round(pts0[:, 1]).astype(int), 0, h - 1)
        z = self.prev_depth[ys, xs]
        ok &= z > 0.1
        self.num_tracked = int(ok.sum())
        if self.num_tracked >= self.min_tracked * 0.3:
            p3d_prev = np.asarray(self.camera.backproject_points(pts0[ok], z[ok]))
            p3dp, valid = pad_bucket(p3d_prev.astype(np.float32))
            m = len(valid)
            dev = self.device
            # T_cur_prev: the previous frame's points reprojected in this one
            T_opt, _, n_inl = optim.pose_optimization(
                torch.eye(4, dtype=torch.float32, device=dev),
                torch.as_tensor(p3dp).to(dev),
                torch.as_tensor(pad_rows(pts1[ok].astype(np.float32), m)).to(dev),
                torch.full((m,), -1.0, dtype=torch.float32, device=dev),
                torch.ones(m, dtype=torch.float32, device=dev),
                torch.as_tensor(valid).to(dev), self._K, 0.0)
            if int(n_inl) >= 10:
                self.cur_Twc = self.cur_Twc @ np.linalg.inv(T_opt.cpu().numpy())

        self.prev_img, self.prev_depth = img_t, depth
        self.prev_pts = self._detect(img_t)   # re-detect to keep the count healthy
        self.poses.append(self.cur_Twc.copy())
        self.timestamps.append(timestamp)
        return self.cur_Twc

    @property
    def trajectory(self):
        return np.asarray([T[:3, 3] for T in self.poses])
