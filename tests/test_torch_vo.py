"""Both visual odometries of the port against the JAX package, frame by
frame, on 8 frames of the 240x320 synthetic streams of tests/test_vo.py and
tests/test_lk_vo_rgbd.py (the reference with x64 off).

- ``VisualOdometryRgbd`` (FAST at threshold 15 + NMS, grid top-k, LK,
  motion-only BA; deterministic): corners identical, every per-frame
  position within 1e-3 m and rotation within 1e-3 rad of the reference's
  (float32 LM in two frameworks, as test_torch_tracking_step.py).
- ``VisualOdometry`` (monocular, fed the reference's own features and
  minimal samples, ``JaxKeySampler(0)``): matches identical; the essential
  matrix agrees only to the float32 conditioning of the reference's
  8-point (tests/test_torch_epipolar.py) under forward motion, so each
  frame's inlier count within 10 % of its matches (measured 2), each step's
  unit direction within 0.3 of the reference's (the step length is the
  ground truth's in both; measured 0.274 at most, while each package's
  steps are up to 0.16 (reference) and 0.22 (port) from the truth's), and
  the trajectories within 0.1 m of each other (measured 0.082)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import JaxKeySampler

from pyslam_tpu.features.orb2 import featuredata_to_numpy
from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.features.tracker import feature_tracker_factory as jax_tracker_factory
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.io.ground_truth import groundtruth_factory as jax_gt_factory
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.visual_odometry import VisualOdometry as JaxVO
from pyslam_tpu.slam.visual_odometry_rgbd import VisualOdometryRgbd as JaxVORgbd
from pyslam_tpu_torch.features.orb2 import FeatureData
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
from pyslam_tpu_torch.io.ground_truth import groundtruth_factory
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.visual_odometry import VisualOdometry
from pyslam_tpu_torch.slam.visual_odometry_rgbd import VisualOdometryRgbd
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

N = 8


def _rot_angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1.0, 1.0)))


def test_rgbd_vo_frame_by_frame():
    with jax.enable_x64(False):
        ds = JaxSyntheticDataset(num_frames=N, sensor_type=JaxSensorType.RGBD,
                                 trajectory="line", step=0.3)
        frames = [(ds.getImage(i).astype(np.float32), ds.getDepth(i).astype(np.float32),
                   ds.getTimestamp(i)) for i in range(N)]
        args = (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
        ref = JaxVORgbd(JaxCamera(*args, fps=ds.fps))
        ref_corners = []
        for i, (img, depth, ts) in enumerate(frames):
            ref.track(img, depth, i, ts)
            ref_corners.append(ref.prev_pts.copy())
    vo = VisualOdometryRgbd(PinholeCamera(*args, fps=ds.fps), device="cpu")
    for i, (img, depth, ts) in enumerate(frames):
        vo.track(img, depth, i, ts)
        np.testing.assert_array_equal(vo.prev_pts, ref_corners[i])
        np.testing.assert_allclose(vo.cur_Twc[:3, 3], ref.poses[i][:3, 3], rtol=0, atol=1e-3)
        assert _rot_angle(vo.cur_Twc[:3, :3], ref.poses[i][:3, :3]) <= 1e-3
    assert vo.num_tracked > 50


def test_mono_vo_frame_by_frame(monkeypatch):
    with jax.enable_x64(False):
        ds = JaxSyntheticDataset(num_frames=N, sensor_type=JaxSensorType.MONOCULAR,
                                 trajectory="line", step=0.4)
        args = (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
        jt = jax_tracker_factory(JaxTrackerConfig(num_features=600, num_levels=4))
        images = [ds.getImage(i).astype(np.float32) for i in range(N)]
        feats = [featuredata_to_numpy(jt.detectAndCompute(img)) for img in images]
        feat_of = {id(img): fd for img, fd in zip(images, feats)}
        monkeypatch.setattr(jt, "detectAndCompute", lambda img: feat_of[id(img)])
        ref = JaxVO(JaxCamera(*args, fps=10.0), jt,
                    groundtruth=jax_gt_factory({"type": "synthetic", "dataset": ds}))
        ref_stats = []
        for i, img in enumerate(images):
            ref.track(img, i, ds.getTimestamp(i))
            ref_stats.append((ref.num_matches, ref.num_inliers))
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=600, num_levels=4),
                                      device="cpu")
    port_feat = {id(img): FeatureData(*[torch.from_numpy(np.array(x)) for x in fd])
                 for img, fd in zip(images, feats)}
    monkeypatch.setattr(tracker, "detectAndCompute", lambda img: port_feat[id(img)])
    vo = VisualOdometry(PinholeCamera(*args, fps=10.0), tracker,
                        groundtruth=groundtruth_factory({"type": "synthetic", "dataset": ds}),
                        sampler=JaxKeySampler(0))
    for i, img in enumerate(images):
        vo.track(img, i, ds.getTimestamp(i))
        n_match, n_inl = ref_stats[i]
        assert vo.num_matches == n_match
        assert abs(vo.num_inliers - n_inl) <= 0.1 * max(n_match, 1)
        if i > 0:
            step = vo.poses[i][:3, 3] - vo.poses[i - 1][:3, 3]
            ref_step = ref.poses[i][:3, 3] - ref.poses[i - 1][:3, 3]
            assert np.linalg.norm(step / np.linalg.norm(step)
                                  - ref_step / np.linalg.norm(ref_step)) <= 0.3, i
    np.testing.assert_allclose(vo.trajectory, ref.trajectory, rtol=0, atol=0.1)
