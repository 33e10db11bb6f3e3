"""Monocular visual odometry (port of ``pyslam_tpu/slam/visual_odometry.py``).

Per frame: extract ORB2 features, match them to the previous frame's
(brute-force Hamming, ratio test, one-to-one), estimate the relative pose
with the essential-matrix RANSAC and its cheirality test on the device,
scale the unit translation by the ground-truth displacement (monocular
scale is unobservable) and accumulate Twc.  The minimal samples come from
``sampler`` (default: a ``torch.Generator`` seeded 0, as the reference
draws from ``PRNGKey(0)``), once per frame that reaches the RANSAC.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from pyslam_tpu_torch.features.tracker import FeatureTracker
from pyslam_tpu_torch.io.ground_truth import GroundTruth
from pyslam_tpu_torch.ops import epipolar
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.utils.padding import pad_bucket, pad_rows


class VoState(enum.Enum):
    NO_IMAGES_YET = 0
    GOT_FIRST_IMAGE = 1


class VisualOdometry:
    def __init__(self, camera: PinholeCamera, feature_tracker: FeatureTracker,
                 groundtruth: GroundTruth | None = None, ransac_threshold_px: float = 1.0,
                 num_ransac_hypotheses: int = 512, min_matches: int = 30, *, sampler=None):
        self.camera = camera
        self.tracker = feature_tracker
        self.device = feature_tracker.device
        self.groundtruth = groundtruth
        self.state = VoState.NO_IMAGES_YET
        self.threshold2 = (ransac_threshold_px / camera.fx) ** 2
        self.num_hyp = num_ransac_hypotheses
        self.min_matches = min_matches
        self.sampler = sampler if sampler is not None else epipolar.generator_sampler(
            self.device, 0)
        self.cur_Twc = np.eye(4)
        self.poses = [np.eye(4)]
        self.timestamps = [0.0]
        self.prev_feats = None
        self.prev_xy = None
        self.num_matches = 0
        self.num_inliers = 0

    def _normalized(self, uv: np.ndarray) -> np.ndarray:
        return np.asarray(self.camera.unproject_points(self.camera.undistort_points(uv)))

    def track(self, img, frame_id: int, timestamp: float = 0.0):
        feats = self.tracker.detectAndCompute(img)
        xy = feats.xy.cpu().numpy()
        if self.state == VoState.NO_IMAGES_YET:
            self.prev_feats, self.prev_xy = feats, xy
            self.state = VoState.GOT_FIRST_IMAGE
            self.timestamps[0] = timestamp
            return self.cur_Twc

        i1, i2 = self.tracker.match(self.prev_feats, feats)
        self.num_matches = len(i1)
        if self.num_matches >= self.min_matches:
            xy1_np, pvalid_np = pad_bucket(self._normalized(self.prev_xy[i1]))
            xy2_np = pad_rows(self._normalized(xy[i2]), len(pvalid_np))
            dev = self.device
            xy1 = torch.as_tensor(xy1_np).to(dev)
            xy2 = torch.as_tensor(xy2_np).to(dev)
            valid = torch.as_tensor(pvalid_np).to(dev)
            E, mask, n_inl = epipolar.find_essential(
                xy1, xy2, valid, self.threshold2, self.num_hyp,
                samples=self.sampler(valid, self.num_hyp, 8))
            self.num_inliers = int(n_inl)
            if self.num_inliers >= 8:
                T21, _ = epipolar.recover_pose(E, xy1, xy2, mask)
                T21 = T21.cpu().numpy()
                # absolute scale from the ground-truth displacement;
                # unit-norm translation without it
                scale = 1.0
                if self.groundtruth is not None:
                    Tw_prev, _ = self.groundtruth.pose_at(self.timestamps[-1])
                    Tw_cur, _ = self.groundtruth.pose_at(timestamp)
                    scale = float(np.linalg.norm(Tw_cur[:3, 3] - Tw_prev[:3, 3]))
                T12 = np.linalg.inv(T21)
                T12[:3, 3] *= scale
                self.cur_Twc = self.cur_Twc @ T12

        self.prev_feats, self.prev_xy = feats, xy
        self.poses.append(self.cur_Twc.copy())
        self.timestamps.append(timestamp)
        return self.cur_Twc

    @property
    def trajectory(self):
        return np.asarray([T[:3, 3] for T in self.poses])
