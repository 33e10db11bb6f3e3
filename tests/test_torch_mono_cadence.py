"""The monocular keyframe cadence of the port on the CPU against the
reference's, on tests/torch_mono_loop.py's stream (a 240x320 circle with a
revisit tail, 800 ORB2 features on 4 levels, the DBOW3 detector).

The reference polls its back-end's device results (``jax.Array.is_ready``)
and its CPU dispatch is asynchronous, so a keyframe job spans frames and a
monocular keyframe waits for an idle back-end: past the bootstrap (four
keyframes, whose jobs run synchronously) no keyframe is made at the frame
right after another.  The port's CPU model of that readiness
(``local_mapping.Pending``) must give the same cadence; before it, the port
made a keyframe at every frame (59 by frame 60).

The count at frame 60 has no stable reference value; it follows where the
map is initialised and whether tracking survives a one-frame baseline
(``python -m tests.torch_mono_loop --package jax|port --frames 61
--log-kf [--x64]``, three runs each):
- the reference with x64 off initialises at frame 11 (its float32
  essential-matrix null vectors reject frames 1-10): 27, 28, 25 keyframes;
- the reference with x64 on initialises at frame 1, as the port does, and
  then loses tracking at frame 27, 9 or 27: 11, 6, 11 keyframes;
- the port initialises at frame 1; with torch's CPU pool at 1, 2 or 4
  threads it loses tracking near frame 10 (8, 8, 9 keyframes), at 8
  threads it keeps tracking (30 keyframes): the float reduction order
  alone decides, as the reference's run-to-run polls do.
So the count is held to the range of all reference runs, 6 to 28, and the
cadence itself to the reference's rule.
"""

from tests import torch_parity  # noqa: F401  (one small torch thread pool per worker)

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam

REFERENCE_RANGE = (6, 28)


def test_mono_keyframe_cadence():
    saved = Parameters.kNumMinFramesBetweenKfs
    Parameters.kNumMinFramesBetweenKfs = 0
    try:
        ds = SyntheticDataset(num_frames=175, period=160, sensor_type=SensorType.MONOCULAR,
                              trajectory="loop")
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=0.0,
                            depth_threshold=20.0)
        slam = Slam(cam, FeatureTrackerConfig(num_features=800, num_levels=4),
                    loop_detector_config="DBOW3", sensor_type=SensorType.MONOCULAR,
                    device="cpu")
        kfs = {}
        made = []
        for i in range(61):
            n = slam.map.num_keyframes()
            slam.track(ds.getImage(i), frame_id=i, timestamp=ds.getTimestamp(i))
            kfs[i] = slam.map.num_keyframes()
            if kfs[i] > n and n > 4:
                made.append(i)
    finally:
        Parameters.kNumMinFramesBetweenKfs = saved
    assert REFERENCE_RANGE[0] <= kfs[60] <= REFERENCE_RANGE[1], kfs
    # past the bootstrap no keyframe follows another at the next frame
    assert len(made) >= 2 and all(b - a >= 2 for a, b in zip(made, made[1:])), made
