"""A SUPERPOINT + DBOW3_INDEPENDENT stereo session (the reference's third
published preset: learned keypoints and 256-d float descriptors, L2
brute-force matching, the session-trained flat vocabulary) in both
packages, on tests/test_slam_e2e.py's 240x320 stereo line stream (20
frames at 0.4 m, its camera: bf = fx * baseline, depth threshold 20 m).

The JAX package does not track this stream with its bundled SuperPoint
weights: it loses frame 1 and resets every second frame from frame 6 on
(measured: frames 0, 7, 9, ..., 19 tracked, one keyframe, ATE 2.2798 m;
the descriptors of the weights trained on synthetic corners match few of
this world's points, ROADMAP.md section 3).  The port is held to that
result: the same frames tracked, resets and keyframes, and its ATE within
1e-3 m of the reference's (measured: equal to the printed digits).  The
reference runs under ``reference_polls_like_the_port``, so that its
back-end's results are ready by the port's CPU rule and not by the host's
load.  The session's descriptor gates and the vocabulary's flag are restored
afterwards in both packages.
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
ATE_TOL = 1e-3


def _cam(cls, ds):
    return cls(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * ds.baseline,
               depth_threshold=20.0)


def _run(slam, ds, eval_fn):
    tracked, resets = [], []
    reset = slam.reset

    def counted_reset():
        resets.append(i)
        reset()

    slam.reset = counted_reset
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
    return dict(tracked=tracked, resets=resets, keyframes=slam.map.num_keyframes(),
                points=slam.map.num_points(), ate=float(ate))


@pytest.fixture(scope="module")
def runs():
    saved = [(P, {k: getattr(P, k) for k in GATES}) for P in (JaxParameters, Parameters)]
    try:
        kw = dict(num_frames=N_FRAMES, trajectory="line", step=0.4)
        jds = JaxSyntheticDataset(sensor_type=JaxSensorType.STEREO, **kw)
        with jax.enable_x64(False), reference_polls_like_the_port():
            ref = _run(JaxSlam(_cam(JaxCamera, jds), "SUPERPOINT",
                               loop_detector_config="DBOW3_INDEPENDENT",
                               sensor_type=JaxSensorType.STEREO), jds, jax_eval_ate)
        ds = SyntheticDataset(sensor_type=SensorType.STEREO, **kw)
        slam = Slam(_cam(PinholeCamera, ds), "SUPERPOINT",
                    loop_detector_config="DBOW3_INDEPENDENT", sensor_type=SensorType.STEREO,
                    device="cpu")
        assert slam.feature_tracker.extractor.trained
        got = _run(slam, ds, eval_ate)
        assert slam.map.points.desc.dtype == np.float32
        assert slam.map.points.desc.shape[1] == 256
        yield ref, got
    finally:
        for P, vals in saved:
            for k, v in vals.items():
                setattr(P, k, v)


def test_same_frames_resets_and_keyframes(runs):
    ref, got = runs
    assert got["tracked"] == ref["tracked"] and len(ref["tracked"]) >= 8
    assert got["resets"] == ref["resets"]
    assert got["keyframes"] == ref["keyframes"] and got["points"] == ref["points"]


def test_ate_against_the_reference(runs):
    ref, got = runs
    assert np.isfinite(got["ate"]) and abs(got["ate"] - ref["ate"]) <= ATE_TOL, (ref, got)
