"""The whole slice on the CPU: the port's stereo Slam on the stream of
tests/test_slam_e2e.py (30 frames, 240x320, straight line, 0.4 m a frame,
600 features on 4 levels) reaches the reference's own floors there: >= 2
keyframes, > 100 points, > 25 tracked frames, ATE < 0.25 m.  The JAX run is
not repeated here; its floors hold in test_slam_e2e.py."""

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu_torch.evaluation.metrics import eval_ate
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.ops.fast import fast_nms
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)


def _stream():
    return SyntheticDataset(num_frames=30, sensor_type=SensorType.STEREO, trajectory="line",
                            step=0.4)


@pytest.fixture(scope="module")
def run():
    ds = _stream()
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=600, num_levels=4),
                sensor_type=SensorType.STEREO, device="cpu")
    frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i)) for i in range(len(ds))]
    for i, (img_l, img_r, ts) in enumerate(frames):
        nxt = None
        if i + 1 < len(frames):
            nxt = {"img": frames[i + 1][0], "img_right": frames[i + 1][1],
                   "frame_id": i + 1, "timestamp": frames[i + 1][2]}
        slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts, next_input=nxt)
    ts, poses = slam.get_final_trajectory()
    return ds, slam, ts, poses


def test_map_floors(run):
    _, slam, _, _ = run
    assert slam.map.num_keyframes() >= 2
    assert slam.map.num_points() > 100
    assert slam.local_mapping.lba_applied >= 1


def test_tracked_and_ate(run):
    ds, _, ts, poses = run
    assert len(ts) > 25, f"only {len(ts)} tracked frames"
    gt_t = np.array([ds.getTimestamp(i) for i in range(len(ds))])
    res = eval_ate(ts, poses[:, :3, 3], gt_t, ds.poses[:, :3, 3], align=True,
                   with_scale=False)
    assert res.rmse < 0.25, res


def test_cpu_tensors_never_count_kernel_launches(run):
    assert fast_nms.launches == 0


@pytest.mark.parametrize("i", [0, 17])
def test_stream_is_byte_identical_to_reference(i):
    a = _stream()
    b = JaxSyntheticDataset(num_frames=30, trajectory="line", step=0.4)
    assert np.array_equal(a.poses, b.poses)
    assert np.array_equal(a.getImage(i), b.getImage(i))
    assert np.array_equal(a.getImageRight(i), b.getImageRight(i))
