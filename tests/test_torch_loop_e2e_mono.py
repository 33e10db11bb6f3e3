"""The monocular loop of the port on the CPU: the port's monocular ``Slam``
with the DBOW3 detector on the stream of tests/test_loop_e2e_mono.py (175
frames of a 240x320 circle with a revisit tail, period 160, 800 features on
4 levels) closes a loop with a Sim(3) of free scale and keeps that test's
floors: at least one loop closed, more than 140 frames tracked, ATE < 0.6 m
after a similarity alignment."""

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu_torch.evaluation.metrics import eval_ate
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam


@pytest.mark.slow
def test_mono_slam_loop_closure_sim3_scale():
    ds = SyntheticDataset(num_frames=175, period=160, sensor_type=SensorType.MONOCULAR,
                          trajectory="loop")
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=0.0,
                        depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=800, num_levels=4),
                loop_detector_config="DBOW3", sensor_type=SensorType.MONOCULAR, device="cpu")
    for i in range(len(ds)):
        slam.track(ds.getImage(i), frame_id=i, timestamp=ds.getTimestamp(i))
    slam.finish()
    lc = slam.loop_closing
    assert lc.num_loops_closed >= 1, "mono loop not closed"
    assert lc.sensor_type == SensorType.MONOCULAR   # Sim(3) with free scale
    ts, poses = slam.get_final_trajectory()
    assert len(ts) > 140, f"only {len(ts)} tracked frames"
    gt_t = np.array([ds.getTimestamp(i) for i in range(len(ds))])
    res = eval_ate(ts, poses[:, :3, 3], gt_t, ds.poses[:, :3, 3], with_scale=True)
    assert res.rmse < 0.6, res
