"""The port's asynchronous global BA (``slam/global_bundle_adjustment.py``)
on the CPU, with the cases of tests/test_async_gba.py: a chunked solve
equals one solve of the same iterations, keyframes and points born during
the solve are carried along, an abort discards the solve, a redispatch
supersedes it, and loop closing owns the runner.  The map: the port's
``Slam`` on 10 frames of the 240x320 stereo line stream (16 for the
born-during case), as in the reference's test."""

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.global_bundle_adjustment import AsyncGBA, global_bundle_adjustment
from pyslam_tpu_torch.slam.slam import Slam


def _track(slam, ds, frames):
    for i in frames:
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.local_mapping.finish()


@pytest.fixture(scope="module")
def slam_ds():
    ds = SyntheticDataset(num_frames=16, sensor_type=SensorType.STEREO, trajectory="line",
                          step=0.45)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=450, num_levels=3),
                sensor_type=SensorType.STEREO, device="cpu")
    _track(slam, ds, range(10))
    assert slam.map.num_keyframes() >= 3
    return slam, ds


def _gba(slam):
    return AsyncGBA(slam.camera, slam.feature_tracker, device="cpu")


def case_chunked_equals_one_solve(slam, ds):
    """Three polled chunks of 3 LM iterations (lam0 resume) apply what one
    synchronous GBA of 9 iterations writes."""
    m = slam.map
    kids = list(m.keyframe_order)
    pids = m.points.alive_ids()
    poses0 = {k: m.keyframes[k].Tcw.copy() for k in kids}
    pos0 = m.points.pos.copy()
    global_bundle_adjustment(m, slam.camera, slam.feature_tracker, iters=9, device="cpu")
    poses = [m.keyframes[k].Tcw.copy() for k in kids]
    points = m.points.pos[pids].copy()
    for k in kids:
        m.keyframes[k].update_pose(poses0[k])
    m.points.pos[:] = pos0
    gba = _gba(slam)
    gba.dispatch(m, iters=9)
    assert gba.running
    polls = 0
    while gba.poll(block=True):
        polls += 1
    assert not gba.running and polls >= 2, "the solve must run as several polled chunks"
    assert gba.runs_completed == 1 and gba.runs_aborted == 0 and np.isfinite(gba.last_cost)
    for i, kid in enumerate(kids):
        np.testing.assert_allclose(m.keyframes[kid].Tcw, poses[i], atol=1e-6)
    np.testing.assert_allclose(m.points.pos[pids], points, atol=1e-5)
    assert np.isfinite(m.points.pos[m.points.alive_ids()]).all()


def case_abort_discards(slam, ds):
    m = slam.map
    gba = _gba(slam)
    poses = {k: kf.Tcw.copy() for k, kf in m.keyframes.items()}
    pos = m.points.pos[m.points.alive_ids()].copy()
    gba.dispatch(m, iters=12)
    gba.abort()
    while gba.poll(block=True):
        pass
    assert gba.runs_aborted == 1 and gba.runs_completed == 0
    for k, T in poses.items():
        np.testing.assert_array_equal(m.keyframes[k].Tcw, T)
    np.testing.assert_array_equal(m.points.pos[m.points.alive_ids()], pos)


def case_redispatch_supersedes(slam, ds):
    gba = _gba(slam)
    gba.dispatch(slam.map, iters=12)
    gba.dispatch(slam.map, iters=6)
    assert gba.runs_aborted == 1
    gba.finish()
    assert gba.runs_completed == 1


def case_loop_closing_owns_gba(slam, ds):
    s2 = Slam(slam.camera, FeatureTrackerConfig(num_features=300, num_levels=3),
              loop_detector_config="DBOW3", sensor_type=SensorType.STEREO, device="cpu")
    assert s2.GBA is s2.loop_closing.gba
    assert s2.tracking.relocalizer is s2.loop_closing.relocalizer
    assert s2.local_mapping.loop_closing is s2.loop_closing
    s2.loop_closing.gba.dispatch(s2.map)      # < 2 keyframes: nothing to do
    assert not s2.GBA.running
    s2.finish()


def case_born_during_propagates(slam, ds):
    """Keyframes and points created while the solve is in flight keep their
    pose relative to the snapshot parent through the apply."""
    m = slam.map
    gba = _gba(slam)
    gba.dispatch(m, iters=6)
    snapshot_kids = set(gba._state["kids"])
    snapshot_pids = set(int(p) for p in gba._state["pids"])
    _track(slam, ds, range(10, 16))
    born = [k for k in m.keyframe_order if k not in snapshot_kids]
    assert born, "no keyframes were created during the solve"
    rel_before = {k: m.keyframes[k].Tcw @ np.linalg.inv(m.keyframes[m.keyframes[k].parent].Tcw)
                  for k in born if m.keyframes[k].parent in m.keyframes}
    assert rel_before
    gba.finish()
    assert gba.runs_completed == 1
    for k, T_rel in rel_before.items():
        kf = m.keyframes[k]
        np.testing.assert_allclose(kf.Tcw @ np.linalg.inv(m.keyframes[kf.parent].Tcw), T_rel,
                                   atol=1e-5)
    born_pids = np.setdiff1d(m.points.alive_ids(), np.asarray(sorted(snapshot_pids)))
    assert len(born_pids) and np.isfinite(m.points.pos[born_pids]).all()


CASES = [case_chunked_equals_one_solve, case_abort_discards, case_redispatch_supersedes,
         case_loop_closing_owns_gba, case_born_during_propagates]   # the last grows the map


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_async_gba(slam_ds, case):
    case(*slam_ds)
