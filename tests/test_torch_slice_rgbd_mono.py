"""The RGBD and monocular slice on the CPU: the port's Slam and both visual
odometries on the streams of tests/test_slam_e2e.py, tests/test_vo.py and
tests/test_lk_vo_rgbd.py (240x320 straight lines, 600 features on 4 levels)
reach the reference's own floors there:

- RGBD Slam, 20 frames at 0.3 m: more than 15 tracked, ATE < 0.25 m;
- monocular Slam, 30 frames at 0.4 m: >= 2 keyframes, more than 12
  tracked, ATE < 0.3 m after a similarity alignment;
- monocular VO with ground-truth scale, 20 frames: more than 20 matches a
  frame, ATE < 0.4 m;
- RGBD VO, 15 frames at 0.3 m: ATE < 0.35 m.
The JAX runs are not repeated here; their floors hold in those files."""

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu_torch.evaluation.metrics import eval_ate
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.ground_truth import groundtruth_factory
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from pyslam_tpu_torch.slam.visual_odometry import VisualOdometry
from pyslam_tpu_torch.slam.visual_odometry_rgbd import VisualOdometryRgbd


def _slam(ds, sensor_type):
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=20.0)
    return Slam(cam, FeatureTrackerConfig(num_features=600, num_levels=4),
                sensor_type=sensor_type, device="cpu")


def _gt_t(ds):
    return np.array([ds.getTimestamp(i) for i in range(len(ds))])


@pytest.fixture(scope="module")
def rgbd_run():
    ds = SyntheticDataset(num_frames=20, sensor_type=SensorType.RGBD, trajectory="line",
                          step=0.3)
    slam = _slam(ds, SensorType.RGBD)
    frames = [(ds.getImage(i), ds.getDepth(i), ds.getTimestamp(i)) for i in range(len(ds))]
    for i, (img, depth, ts) in enumerate(frames):
        nxt = None
        if i + 1 < len(frames):
            nxt = {"img": frames[i + 1][0], "depth": frames[i + 1][1], "frame_id": i + 1,
                   "timestamp": frames[i + 1][2]}
        slam.track(img, depth=depth, frame_id=i, timestamp=ts, next_input=nxt)
    return ds, slam, *slam.get_final_trajectory()


def test_rgbd_tracked_and_ate(rgbd_run):
    ds, slam, ts, poses = rgbd_run
    assert len(ts) > 15, f"only {len(ts)} tracked frames"
    res = eval_ate(ts, poses[:, :3, 3], _gt_t(ds), ds.poses[:, :3, 3], with_scale=False)
    assert res.rmse < 0.25, res


def test_rgbd_map(rgbd_run):
    _, slam, _, _ = rgbd_run
    assert slam.map.num_keyframes() >= 2 and slam.map.num_points() > 100
    assert slam.local_mapping.lba_applied >= 1


@pytest.fixture(scope="module")
def mono_run():
    ds = SyntheticDataset(num_frames=30, sensor_type=SensorType.MONOCULAR, trajectory="line",
                          step=0.4)
    slam = _slam(ds, SensorType.MONOCULAR)
    for i in range(len(ds)):
        slam.track(ds.getImage(i), frame_id=i, timestamp=ds.getTimestamp(i))
    return ds, slam, *slam.get_final_trajectory()


def test_mono_keyframes_and_tracked(mono_run):
    _, slam, ts, _ = mono_run
    assert slam.map.num_keyframes() >= 2
    assert len(ts) > 12, f"only {len(ts)} tracked frames"


def test_mono_ate_with_scale(mono_run):
    ds, _, ts, poses = mono_run
    res = eval_ate(ts, poses[:, :3, 3], _gt_t(ds), ds.poses[:, :3, 3], with_scale=True)
    assert res.rmse < 0.3, res


def test_mono_vo():
    ds = SyntheticDataset(num_frames=20, sensor_type=SensorType.MONOCULAR, trajectory="line",
                          step=0.4)
    gt = groundtruth_factory({"type": "synthetic", "dataset": ds})
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=10.0)
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=600, num_levels=4),
                                      device="cpu")
    vo = VisualOdometry(cam, tracker, groundtruth=gt)
    for i in range(len(ds)):
        vo.track(ds.getImage(i), i, ds.getTimestamp(i))
        assert vo.num_matches > 20 or i == 0, f"frame {i}: {vo.num_matches} matches"
    res = eval_ate(np.asarray(vo.timestamps), vo.trajectory, gt.timestamps,
                   gt.positions[:len(vo.poses)], align=True, with_scale=False)
    assert res.rmse < 0.4, res


def test_rgbd_vo():
    ds = SyntheticDataset(num_frames=15, sensor_type=SensorType.RGBD, trajectory="line",
                          step=0.3)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps)
    vo = VisualOdometryRgbd(cam, device="cpu")
    for i in range(len(ds)):
        vo.track(ds.getImage(i), ds.getDepth(i), i, ds.getTimestamp(i))
    res = eval_ate(np.asarray(vo.timestamps), vo.trajectory, _gt_t(ds), ds.poses[:, :3, 3],
                   with_scale=False)
    assert res.rmse < 0.35, res
