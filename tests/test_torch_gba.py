"""The port's asynchronous global BA (``slam/global_bundle_adjustment.py``)
on the CPU, with the cases of tests/test_async_gba.py: a chunked solve
equals one solve of the same iterations, keyframes and points born during
the solve are carried along, an abort discards the solve, a redispatch
supersedes it, and loop closing owns the runner.  The map: the port's
``Slam`` on 10 frames of the 240x320 stereo line stream (16 for the
born-during case), as in the reference's test.

First, the solve itself against the JAX package's on that map, saved in
the packages' shared schema and loaded by both; each package builds the
whole-map problem with its own ``build_full_problem`` (identical array for
array).  The same seeded perturbation of the free poses (1 cm, 2 mrad) and
of the points (5 cm), which local BA had already settled, gives the solve
work to do; each package then solves it unsharded in float32, the JAX
package with x64 off as it runs outside the tests, and in float64.  Held:
in float64 the two solutions within 1e-9 (poses) and 1e-8 m (points); in
float32 the final costs within 1e-5 of each other (relative), and the
port's poses and the points that the problem holds (three or more
observations, two rays at least 2 degrees apart) no farther from the
float64 solution than twice the reference's float32 distance from it.
Points seen twice from nearly the same place are not held: float32
rounding moves them by far more than any other in both packages, each
solve in its own way (``python -m tests.torch_gba_placement`` bins the
displacements of the main stage's full-width map by observations and
parallax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.features.tracker import feature_tracker_factory as jax_tracker_factory
from pyslam_tpu.ops import optim as joptim
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.global_bundle_adjustment import build_full_problem as jax_problem
from pyslam_tpu.slam.map_serialization import map_from_json as jax_map_from_json
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.ops import optim
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.global_bundle_adjustment import (AsyncGBA, build_full_problem,
                                                            global_bundle_adjustment)
from pyslam_tpu_torch.slam.map_serialization import map_from_json, map_to_json
from pyslam_tpu_torch.slam.slam import Slam
from tests.torch_gba_placement import parallax_deg

ITERS = 10            # chip_smoke.py phase 21b's
COST_RTOL = 1e-5
FLOAT32_FACTOR = 2.0
HELD_OBS, HELD_PARALLAX = 3, 2.0   # observations, degrees
FLOAT_FIELDS = ("poses", "points", "uv", "ur", "sigma2", "K", "bf")
TRACKER = dict(num_features=450, num_levels=3)


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
    slam = Slam(cam, FeatureTrackerConfig(**TRACKER), sensor_type=SensorType.STEREO,
                device="cpu")
    _track(slam, ds, range(10))
    assert slam.map.num_keyframes() >= 3
    return slam, ds


@pytest.fixture(scope="module")
def problems(slam_ds):
    """The session's map (as the async cases find it: they run after these
    tests and grow it) as each package's whole-map problem."""
    slam, _ = slam_ds
    cam, tracker = slam.camera, slam.feature_tracker
    d = map_to_json(slam.map)
    tp, kids, pids = build_full_problem(map_from_json(d, tracker, cam), cam, tracker,
                                        device="cpu")
    jcam = JaxCamera.from_json(cam.to_json())
    jtracker = jax_tracker_factory(JaxTrackerConfig(**TRACKER))
    jp, jkids, jpids = jax_problem(jax_map_from_json(d, jtracker, jcam), jcam, jtracker)
    return jp, jkids, jpids, tp, kids, pids


def _perturbed(jp, tp):
    r = np.random.default_rng(0)
    poses = tp.poses.numpy().copy()
    for i in np.nonzero(~tp.fixed.numpy())[0]:
        poses[i, :3, :3] = Rotation.from_rotvec(r.normal(0, 2e-3, 3)).as_matrix() \
            @ poses[i, :3, :3]
        poses[i, :3, 3] += r.normal(0, 1e-2, 3)
    points = tp.points.numpy() + r.normal(0, 5e-2, tp.points.shape).astype(np.float32)
    poses = poses.astype(np.float32)
    return (jp._replace(poses=jnp.asarray(poses), points=jnp.asarray(points)),
            tp._replace(poses=torch.from_numpy(poses), points=torch.from_numpy(points)))


def test_both_packages_build_the_same_problem(problems):
    jp, jkids, jpids, tp, kids, pids = problems
    assert list(jkids) == list(kids) and len(kids) >= 3
    np.testing.assert_array_equal(np.asarray(jpids), np.asarray(pids))
    for f in tp._fields:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b.astype(a.dtype)), f


def _solve_both(jp, tp, dtype):
    """(reference, port) solutions (poses, points, cost) as float64 numpy, each
    package's problem cast to ``dtype`` (the JAX package with x64 off for
    float32, as outside the tests)."""
    tp = tp._replace(**{f: getattr(tp, f).to(dtype) for f in FLOAT_FIELDS})
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        jp = jp._replace(**{f: jnp.asarray(np.asarray(getattr(jp, f)), jdt)
                            for f in FLOAT_FIELDS})
        ref = [np.asarray(x, np.float64) for x in joptim.bundle_adjust(jp, iters=ITERS)]
    port = [x.double().numpy() for x in optim.bundle_adjust(tp, iters=ITERS)]
    return ref, port


def test_gba_solves_as_the_reference(problems):
    """In float64 the two packages' solves agree to their rounding (the same
    LM, damping, robust kernel, gauge and Schur complement); in float32 the
    final costs agree, and the port's poses and held points lie no farther
    from the float64 solution than the reference's do, within a factor of
    two (the same rounding, summed in another order)."""
    jp, _, _, tp, _, _ = problems
    jp, tp = _perturbed(jp, tp)
    r64, p64 = _solve_both(jp, tp, torch.float64)
    cost0 = float(optim.ba_cost_and_chi2(tp)[0])
    assert r64[2] < 0.5 * cost0, (r64[2], cost0)                # the solve did work
    assert np.abs(p64[0] - r64[0]).max() <= 1e-9
    assert np.abs(p64[1] - r64[1]).max() <= 1e-8
    assert abs(p64[2] - r64[2]) <= 1e-9 * r64[2]
    r32, p32 = _solve_both(jp, tp, torch.float32)
    assert abs(p32[2] - r32[2]) <= COST_RTOL * r32[2], (p32[2], r32[2])
    num_obs = np.bincount(tp.pt_idx.numpy(), minlength=tp.points.shape[0])
    held = (num_obs >= HELD_OBS) & (parallax_deg(tp, r64[1]) >= HELD_PARALLAX)
    assert held.sum() >= 20, held.sum()
    pose_err = {k: np.abs(x[0] - r64[0]).max() for k, x in (("ref", r32), ("port", p32))}
    held_err = {k: np.linalg.norm(x[1] - r64[1], axis=1)[held].max()
                for k, x in (("ref", r32), ("port", p32))}
    assert pose_err["port"] <= FLOAT32_FACTOR * pose_err["ref"], pose_err
    assert held_err["port"] <= FLOAT32_FACTOR * held_err["ref"], held_err


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
