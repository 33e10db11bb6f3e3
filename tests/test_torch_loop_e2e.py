"""The whole loop-closing slice of the port on the CPU: the port's stereo
``Slam`` with the DBOW3 detector on the stream of
tests/test_loop_e2e.py::test_stereo_slam_loop_closure (175 frames of a
240x320 circle with a revisit tail, period 160, 600 features on 4 levels)
keeps that test's floors: at least one loop closed, at least 168 frames
tracked, ATE < 1.2 m."""

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
def test_stereo_slam_loop_closure():
    ds = SyntheticDataset(num_frames=175, period=160, sensor_type=SensorType.STEREO,
                          trajectory="loop")
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=600, num_levels=4),
                loop_detector_config="DBOW3", sensor_type=SensorType.STEREO, device="cpu")
    for i in range(len(ds)):
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.finish()
    assert slam.loop_closing.num_loops_closed >= 1, "stereo loop was not detected/closed"
    assert slam.GBA.runs_completed >= 1
    ts, poses = slam.get_final_trajectory()
    assert len(ts) >= 168, f"only {len(ts)} tracked frames"
    gt_t = np.array([ds.getTimestamp(i) for i in range(len(ds))])
    res = eval_ate(ts, poses[:, :3, 3], gt_t, ds.poses[:, :3, 3], with_scale=False)
    assert res.rmse < 1.2, res
