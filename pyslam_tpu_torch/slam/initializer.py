"""Map bootstrap (port of ``pyslam_tpu/slam/initializer.py``).

- Stereo and RGBD: the first frame with enough depth-valid keypoints
  becomes the first keyframe, and its depths become map points.
- Monocular: hold a reference frame and match each incoming frame against
  it (ratio test); estimate the essential matrix (512-hypothesis RANSAC on
  the device), recover the pose by cheirality, triangulate the inliers on
  the host in float64, keep the points that pass the depth and reprojection
  checks, require enough of them to pass the parallax check too, normalise
  the median depth to 1 and create the first two keyframes.  Every 10th
  failure advances the reference frame.

The minimal samples come from ``sampler`` (default: one ``torch.Generator``
seeded 42, as the reference draws from ``PRNGKey(42)``), called once per
essential-matrix attempt; the parity tests pass the reference's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.ops import epipolar, geometry, hamming, matching
from pyslam_tpu_torch.slam.frame import Frame, KeyFrame
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.utils.padding import pad_bucket, pad_rows


@dataclass
class InitializerOutput:
    success: bool
    kf_ref: KeyFrame | None = None
    kf_cur: KeyFrame | None = None
    pids: np.ndarray | None = None


class Initializer:
    def __init__(self, sensor_type: SensorType, num_features: int = 2000, *,
                 device: torch.device | str = "cuda", sampler=None):
        self.sensor_type = sensor_type
        self.device = torch.device(device)
        # the reference's absolute thresholds assume 2000 features: scale them
        s = num_features / 2000.0
        is_mono = sensor_type == SensorType.MONOCULAR
        self.min_features = max(20, int((Parameters.kInitializerNumMinFeatures if is_mono
                                         else Parameters.kInitializerNumMinFeaturesStereo // 4)
                                        * s))
        self.min_inliers = max(30, num_features // 20)      # essential inliers
        self.min_triangulated = max(20, int((Parameters.kInitializerNumMinTriangulatedPoints
                                             if is_mono else
                                             Parameters.kInitializerNumMinTriangulatedPointsStereo)
                                            * s) // 2)
        self.sampler = sampler   # made at the first monocular attempt when None
        self.ref_frame: Frame | None = None
        self.num_failures = 0

    def reset(self):
        self.ref_frame = None
        self.num_failures = 0

    # ------------------------------------------------------------- stereo
    def try_initialize_stereo(self, f: Frame, slam_map: Map) -> InitializerOutput:
        good = (f.depths > 0) & f.valid
        if good.sum() < self.min_features:
            return InitializerOutput(False)
        kf = KeyFrame(f)
        slam_map.add_keyframe(kf)
        pts_w, idxs = f.unproject_keypoints(np.nonzero(good)[0])
        pids = slam_map.add_points_for_keyframe(kf, idxs, pts_w)
        slam_map.update_connections(kf)
        return InitializerOutput(True, kf_ref=kf, kf_cur=kf, pids=pids)

    # ---------------------------------------------------------------- mono
    def try_initialize_mono(self, f: Frame, slam_map: Map) -> InitializerOutput:
        if self.ref_frame is None or not self.ref_frame.valid.any():
            self.ref_frame = f
            return InitializerOutput(False)
        ref = self.ref_frame
        dev = self.device
        idx2, _ = matching.match_ratio_test(
            hamming.hamming_distance_matrix(ref.dev("des"), f.dev("des")),
            Parameters.kMaxDescriptorDistance,
            ratio=Parameters.kInitializerFeatureMatchRatioTest,
            valid_a=ref.dev("valid"), valid_b=f.dev("valid"))
        idx2 = idx2.cpu().numpy()
        i1 = np.nonzero(idx2 >= 0)[0]
        i2 = idx2[i1]
        if len(i1) < self.min_features:
            return self._failure(f)

        cam = f.camera
        xy1_np, pvalid_np = pad_bucket(np.asarray(cam.unproject_points(ref.kps[i1])))
        xy2_np = pad_rows(np.asarray(cam.unproject_points(f.kps[i2])), len(pvalid_np))
        xy1 = torch.as_tensor(xy1_np).to(dev)
        xy2 = torch.as_tensor(xy2_np).to(dev)
        pvalid = torch.as_tensor(pvalid_np).to(dev)
        th2 = (1.0 / cam.fx) ** 2 * 3.84
        if self.sampler is None:
            self.sampler = epipolar.generator_sampler(dev, 42)
        E, mask, n_inl = epipolar.find_essential(xy1, xy2, pvalid, th2, 512,
                                                 samples=self.sampler(pvalid, 512, 8))
        if int(n_inl) < self.min_inliers:
            return self._failure(f)
        T21_t, front = epipolar.recover_pose(E, xy1, xy2, mask)
        good_t = mask & front
        T21 = T21_t.cpu().numpy()
        if int(good_t.sum()) < self.min_inliers:
            return self._failure(f)

        # triangulate on the host in float64, check on the device in float32
        pts = geometry.triangulate_dlt_np(np.eye(4), T21, xy1_np, xy2_np)
        sig1 = pad_rows(ref.feature_tracker.sigma2[ref.levels[i1]] / cam.fx ** 2,
                        len(pvalid_np), 1.0)
        sig2 = pad_rows(f.feature_tracker.sigma2[f.levels[i2]] / cam.fx ** 2,
                        len(pvalid_np), 1.0)
        pts_t = torch.as_tensor(pts.astype(np.float32)).to(dev)
        T1 = torch.eye(4, dtype=torch.float32, device=dev)
        sig1_t = torch.as_tensor(sig1).to(dev)
        sig2_t = torch.as_tensor(sig2).to(dev)

        def checks(cos_max_parallax):
            return geometry.triangulation_checks(pts_t, T1, T21_t, xy1, xy2, sig1_t, sig2_t,
                                                 chi2_th=5.991,
                                                 cos_max_parallax=cos_max_parallax)

        # every point that passes depth and reprojection is kept; the
        # parallax check only gates the initialisation as a whole
        keep = good_t & pvalid
        ok = (checks(1.1) & keep).cpu().numpy()
        ok_parallax = (checks(Parameters.kCosMaxParallax) & keep).cpu().numpy()
        n_real = len(i1)
        ok, ok_parallax, pts = ok[:n_real], ok_parallax[:n_real], pts[:n_real]
        if ok_parallax.sum() < self.min_triangulated:
            return self._failure(f)

        # scale: median depth in the reference frame -> 1
        med = float(np.median(pts[ok][:, 2]))
        if med <= 0:
            return self._failure(f)
        T21_scaled = T21.copy()          # float32, as the reference scales it
        T21_scaled[:3, 3] /= med
        ref.update_pose(np.eye(4))
        f.update_pose(T21_scaled)
        kf1 = KeyFrame(ref)
        kf2 = KeyFrame(f)
        slam_map.add_keyframe(kf1)
        slam_map.add_keyframe(kf2)
        sel = np.nonzero(ok)[0]
        pids = slam_map.add_points_for_keyframe(kf1, i1[sel], pts[sel] / med, kf2=kf2,
                                                kp_idxs2=i2[sel])
        slam_map.update_point_descriptors_and_normals(pids)
        slam_map.update_connections(kf2)
        slam_map.update_connections(kf1)
        return InitializerOutput(True, kf_ref=kf1, kf_cur=kf2, pids=pids)

    def _failure(self, f: Frame) -> InitializerOutput:
        """Count a failed attempt; every 10th advances the reference frame
        (too eager an advance resets the baseline and starves parallax
        under forward motion)."""
        self.num_failures += 1
        if self.num_failures % 10 == 0:
            self.ref_frame = f
        return InitializerOutput(False)

    # --------------------------------------------------------------- entry
    def initialize(self, f: Frame, slam_map: Map, tracker=None) -> InitializerOutput:
        if self.sensor_type in (SensorType.STEREO, SensorType.RGBD):
            return self.try_initialize_stereo(f, slam_map)
        return self.try_initialize_mono(f, slam_map)
