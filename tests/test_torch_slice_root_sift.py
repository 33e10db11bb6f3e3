"""A ROOT_SIFT stereo session (the reference's published float preset,
cv2 SIFT on the host with RootSIFT descriptors) in both packages, on
tests/test_slam_e2e.py's 240x320 stereo line stream (20 frames at 0.4 m,
its camera: bf = fx * baseline, depth threshold 20 m).

Held equal: the frames tracked and the number of keyframes (measured: both
20/20 with 15 keyframes, 872 map points).  Both stay under that test's
0.25 m ATE floor (measured: reference 0.0442 m, port 0.0402 m; the float
paths differ in the last bits of L2 distances and the pose optimisation).
The reference runs under ``reference_polls_like_the_port``: polled by
``jax.Array.is_ready``, its keyframes followed the host's load (16 once
inside the 6-worker suite); so it keeps 15, alone and beside ten busy
processes.
The session's descriptor gates that ``Slam`` writes into ``Parameters``
(ROOT_SIFT's L2 0.9 and 0.45) are restored afterwards in both packages.
"""

import jax
import numpy as np
import pytest

from pyslam_tpu.config_parameters import Parameters as JaxParameters
from pyslam_tpu.evaluation.metrics import eval_ate as jax_eval_ate
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.slam import Slam as JaxSlam
from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.evaluation.metrics import eval_ate
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from tests import torch_parity  # noqa: F401  (one small torch thread pool per worker)
from tests.torch_parity import reference_polls_like_the_port
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

N_FRAMES = 20
GATES = ("kMaxDescriptorDistance", "kMaxOrbDistanceSearchByReproj")


def _cam(cls, ds):
    return cls(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * ds.baseline,
               depth_threshold=20.0)


def _run(slam, ds, eval_fn):
    tracked = []
    for i in range(N_FRAMES):
        n = len(slam.tracking.history.timestamps)
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
        if len(slam.tracking.history.timestamps) > n:
            tracked.append(i)
    slam.finish()
    ts, T = slam.tracking.history.final_trajectory(slam.map)
    gt_t = np.array([ds.getTimestamp(i) for i in range(N_FRAMES)])
    ate = eval_fn(ts, np.asarray(T)[:, :3, 3], gt_t, ds.poses[:N_FRAMES, :3, 3], align=True,
                  with_scale=False).rmse
    return tracked, slam.map.num_keyframes(), float(ate)


@pytest.fixture(scope="module")
def runs():
    saved = [(P, {k: getattr(P, k) for k in GATES}) for P in (JaxParameters, Parameters)]
    try:
        kw = dict(num_frames=N_FRAMES, trajectory="line", step=0.4)
        jds = JaxSyntheticDataset(sensor_type=JaxSensorType.STEREO, **kw)
        with jax.enable_x64(False), reference_polls_like_the_port():
            ref = _run(JaxSlam(_cam(JaxCamera, jds), "ROOT_SIFT",
                               sensor_type=JaxSensorType.STEREO), jds, jax_eval_ate)
        ds = SyntheticDataset(sensor_type=SensorType.STEREO, **kw)
        slam = Slam(_cam(PinholeCamera, ds), "ROOT_SIFT", sensor_type=SensorType.STEREO,
                    device="cpu")
        got = _run(slam, ds, eval_ate)
        assert slam.map.points.desc.dtype == np.float32
        assert slam.local_mapping._kf_store.des.shape[-1] == 128
        yield ref, got
    finally:
        for P, vals in saved:
            for k, v in vals.items():
                setattr(P, k, v)


def test_same_frames_and_keyframes(runs):
    (ref_tracked, ref_kfs, _), (tracked, kfs, _) = runs
    assert tracked == ref_tracked == list(range(N_FRAMES))
    assert kfs == ref_kfs


def test_ate_floor(runs):
    (_, _, ref_ate), (_, _, ate) = runs
    assert ref_ate < 0.25 and ate < 0.25, (ref_ate, ate)
