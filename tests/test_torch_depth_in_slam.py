"""The depth estimators in the port's SLAM loop: the mirror of
tests/test_depth_in_slam.py (the MONOCULAR -> RGBD upgrade by a depth
estimator, and the stereo TSDF fed by the integrator's SGM provider), the
integrator's host-depth branch, the prefetch rule, and the entry points
``main_slam --sensor mono --depth_estimator sgbm`` and
``main_depth_prediction`` on the CPU.

The SGBM upgrade also runs through the JAX package's ``Slam`` on the
first ``N_FRAMES`` = 11 frames, with x64 off and under
``tests.torch_parity.reference_polls_like_the_port`` (its back-end results
ready by the port's CPU rule, not by the host's load), as the slice tests
run it: what the assertions need (every frame tracked, the keyframe
counts within one, a trajectory of ten 0.4 m steps against the ground
truth's length).  Held equal: the frames tracked (11/11), the sensor type
(RGBD) and the keyframe decision of every frame before frame 10
(keyframes at frames 0, 3 and 7 in both).  The two sessions part in
their ORB2 keypoints from frame 0 on: the port's pyramid column pass
keeps one FMA chain, at most 3.05e-5 grey levels from the reference's
(an accepted deviation, ROADMAP.md section 3), which reorders near-tied
responses at level 1 and keeps another keypoint at the 500-slot cut
(given the reference's pyramid, the port's keypoints, responses and
descriptors are identical: ``python -m tests.torch_orb2_ties --preset
ORB2 --features 500 --levels 4 --frames 2``).  From frame 1 on the
inlier counts part by one (153 against 154), and at frame 10 the
reference counts 23 tracked close points under the threshold of 25 and
makes a keyframe where the port counts 25 and makes none (its next is at
frame 12): 4 keyframes against 3 over these 11 frames.  Given the
reference's pyramid (``tests.torch_parity.
port_extracts_from_the_reference_pyramid``) the port makes its keyframes
at the reference's frames over all 11 (0, 3, 7 and 10), which pins the
parting at frame 10 on the pyramid.  Both meet the
reference test's floors (ATE is not among them; the metric-scale floor
is the trajectory length within 25 % of the ground truth's, with no
alignment).

The host-depth branch: an estimator without a device path fills the same
voxel table in both packages' integrators, bit for bit, from the same
depth.  The tests after the upgrade's are in
tests/test_torch_depth_in_slam_paths.py.
"""

import functools

import jax
import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)
from pyslam_tpu.depth_estimation.depth_estimator import (DepthEstimatorType as JaxType,
                                                        depth_estimator_factory as jax_factory)
from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.slam import Slam as JaxSlam
from pyslam_tpu_torch.depth_estimation.depth_estimator import (DepthEstimatorType,
                                                               depth_estimator_factory)
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from tests.torch_parity import (port_extracts_from_the_reference_pyramid,
                                reference_polls_like_the_port)
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

N_FRAMES = 11
FIRST_KF_APART = 10   # the first frame whose keyframe decision differs


def _cam(cls, ds):
    return cls(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * ds.baseline,
               depth_threshold=20.0)


def _run(slam, ds):
    """(frames tracked, frames that made a keyframe)."""
    tracked, kf_frames = [], []
    for i in range(len(ds)):
        n = len(slam.tracking.history.timestamps)
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
        if len(slam.tracking.history.timestamps) > n:
            tracked.append(i)
        kf = slam.tracking.kf_ref
        if kf is not None and kf.id == i:
            kf_frames.append(i)
    slam.finish()
    return tracked, kf_frames


@pytest.fixture(scope="module")
def upgraded():
    kw = dict(num_frames=N_FRAMES, trajectory="line", step=0.4)
    jds = JaxSyntheticDataset(sensor_type=JaxSensorType.STEREO, **kw)
    jcam = _cam(JaxCamera, jds)
    with jax.enable_x64(False), reference_polls_like_the_port():
        ref = JaxSlam(jcam, JaxTrackerConfig(num_features=500, num_levels=4),
                      sensor_type=JaxSensorType.MONOCULAR,
                      depth_estimator=jax_factory(JaxType.DEPTH_SGBM, camera=jcam,
                                                  max_disparity=64))
        ref_tracked = _run(ref, jds)
    ds = SyntheticDataset(sensor_type=SensorType.STEREO, **kw)
    # each frame is rendered and its SGBM depth estimated once: the session
    # given the reference's pyramid takes them again
    ds.getImage = functools.lru_cache(maxsize=None)(ds.getImage)
    ds.getImageRight = functools.lru_cache(maxsize=None)(ds.getImageRight)
    slam = _port_upgrade(ds)
    assert slam.sensor_type == SensorType.RGBD
    tracked = _run(slam, ds)
    return ref, ref_tracked, slam, tracked, ds


def _port_upgrade(ds, est=None):
    """The port's upgraded session; a new SGBM estimator remembers its
    depth for each stereo pair it is given."""
    cam = _cam(PinholeCamera, ds)
    if est is None:
        est = depth_estimator_factory(DepthEstimatorType.DEPTH_SGBM, camera=cam,
                                      max_disparity=64, device="cpu")
        infer, seen = est.infer, {}

        def remembered(img, img_right=None):
            key = (np.asarray(img).tobytes(), np.asarray(img_right).tobytes())
            if key not in seen:
                seen[key] = infer(img, img_right=img_right)
            return seen[key]

        est.infer = remembered
    return Slam(cam, FeatureTrackerConfig(num_features=500, num_levels=4),
                sensor_type=SensorType.MONOCULAR, depth_estimator=est, device="cpu")


def test_depth_estimator_upgrades_mono_to_rgbd(upgraded):
    """The floors of tests/test_depth_in_slam.py's test of the same name."""
    _, _, slam, _, ds = upgraded
    assert slam.state.name == "OK"
    assert slam.map.num_points() > 100
    kf0 = slam.map.keyframes[slam.map.keyframe_order[0]]
    assert (kf0.depths > 0).sum() > 50, "estimated depth not attached"
    ts, poses = slam.get_final_trajectory()
    assert len(ts) >= len(ds) - 1
    gt = ds.poses[:, :3, 3]
    est_len = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1).sum()
    gt_len = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert abs(est_len - gt_len) / gt_len < 0.25, (est_len, gt_len)


def test_upgrade_tracks_as_the_reference(upgraded):
    ref, ref_tracked, slam, tracked, _ = upgraded
    assert ref.sensor_type.name == slam.sensor_type.name == "RGBD"
    (tracked, kf_frames), (ref_tracked, ref_kf_frames) = tracked, ref_tracked
    assert tracked == ref_tracked == list(range(N_FRAMES))
    before = [f for f in kf_frames if f < FIRST_KF_APART]
    assert before == [f for f in ref_kf_frames if f < FIRST_KF_APART] == [0, 3, 7], \
        (kf_frames, ref_kf_frames)
    assert abs(slam.map.num_keyframes() - ref.map.num_keyframes()) <= 1, \
        (slam.map.num_keyframes(), ref.map.num_keyframes())


def test_upgrade_keyframes_as_the_reference_given_its_pyramid(upgraded):
    """With the reference's image pyramid, the port's session tracks the
    same frames and makes its keyframes at the same frames as the
    reference's, past frame 10 where the two part on their own pyramids."""
    _, (ref_tracked, ref_kf_frames), slam, _, ds = upgraded
    with port_extracts_from_the_reference_pyramid():
        tracked, kf_frames = _run(_port_upgrade(ds, est=slam.depth_estimator), ds)
    assert FIRST_KF_APART in ref_kf_frames
    assert tracked == ref_tracked and kf_frames == ref_kf_frames == [0, 3, 7, 10], \
        (kf_frames, ref_kf_frames)
