"""The loop-closing slice of the port against the JAX package on one map:
the JAX ``Slam`` (no loop detector, x64 off as it runs outside the tests,
local mapping drained after every frame) tracks 40 frames of the 240x320
stereo loop stream (period 160), the map is
carried across with ``interop.map_from_tpu_json``, and both packages'
``LoopClosing`` register its keyframes in their databases, then check
keyframe pairs and correct one.  The port draws the reference's minimal
samples (``tests.torch_parity.JaxKeySampler``, the split sequence of
``PRNGKey(11)``).

Held identical: the vocabulary trees and every keyframe's words, the BoW
matches (the correspondence sets handed to the Sim(3) RANSAC, bit for bit),
the accept/reject decisions, the pose graph's edges and measurements and
the observations after the loop fuse.  Within tolerance: S12 (2e-4;
float32 SVD and LM in two frameworks), the inlier counts (+-2 of N, see
test_torch_sim3.py), the pose graph's result and the corrected keyframe
poses and points (1e-3, in metres on a 12 m circle: float32 Gauss-Newton
over 30 iterations).  Two departures of the port are held to their own
rule (ORB-SLAM's) instead: the pose graph's measurement of a loop
connection, and the reference keyframe of a point that the correction
moved.
"""

import jax
import numpy as np
import pytest

from tests.torch_parity import JaxKeySampler, np_

import pyslam_tpu.ops.optim as joptim
import pyslam_tpu.ops.procrustes as jproc
import pyslam_tpu_torch.ops.optim as optim
import pyslam_tpu_torch.ops.procrustes as procrustes
from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.loop_closing.loop_closing import LoopClosing as JaxLoopClosing
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.map_serialization import map_to_json
from pyslam_tpu.slam.slam import Slam as JaxSlam
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
from pyslam_tpu_torch.interop import map_from_tpu_json
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.loop_closing.loop_closing import LoopClosing
from pyslam_tpu_torch.slam.camera import PinholeCamera
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

N_FRAMES = 40
S_TOL = 2e-4
POSE_TOL = 1e-3
MARGIN = 2


def _cam(cls, ds):
    return cls(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * ds.baseline,
               depth_threshold=20.0)


def _register(lc, m):
    """Describe every keyframe and add it to the database, in order."""
    words = {}
    for kid in m.keyframe_order:
        w, g = lc.detector.describe_frame(m.keyframes[kid])
        lc.db.add(kid, w, g)
        lc.detector.vocabulary.add_document(w)
        words[kid] = w
    return words


@pytest.fixture(scope="module")
def session():
    ds = JaxSyntheticDataset(num_frames=N_FRAMES, period=160, trajectory="loop",
                             sensor_type=JaxSensorType.STEREO)
    with jax.enable_x64(False):
        js = JaxSlam(_cam(JaxCamera, ds), JaxTrackerConfig(num_features=600, num_levels=4),
                     sensor_type=JaxSensorType.STEREO)
        for i in range(N_FRAMES):
            js.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                     timestamp=ds.getTimestamp(i))
            # the reference's back end polls its device results by readiness
            # (``jax.Array.is_ready``): drained each frame, its keyframes do
            # not depend on the host's load
            js.local_mapping.finish()
        js.finish()
        jlc = JaxLoopClosing(js.map, js.camera, js.feature_tracker, "DBOW3",
                             sensor_type=JaxSensorType.STEREO)
        jwords = _register(jlc, js.map)
    cam = _cam(PinholeCamera, ds)
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=600, num_levels=4),
                                      device="cpu")
    pmap = map_from_tpu_json(map_to_json(js.map), cam, tracker)
    plc = LoopClosing(pmap, cam, tracker, "DBOW3", sensor_type=SensorType.STEREO,
                      device="cpu", sampler=JaxKeySampler(11))
    pwords = _register(plc, pmap)
    return dict(js=js, jlc=jlc, plc=plc, jwords=jwords, pwords=pwords, results={})


def test_map_and_vocabulary(session):
    js, jlc, plc = session["js"], session["jlc"], session["plc"]
    assert js.map.num_keyframes() >= 12
    jv, pv = jlc.detector.vocabulary, plc.detector.vocabulary
    for f in ("centroids", "children", "node_word", "word_level_node"):
        np.testing.assert_array_equal(getattr(pv, f), getattr(jv, f))
    for kid, w in session["jwords"].items():
        np.testing.assert_array_equal(session["pwords"][kid], w)
        np.testing.assert_allclose(plc.db.kf_gdes[kid], jlc.db.kf_gdes[kid], atol=1e-6)


def _recorded(monkeypatch, mod, name, store):
    orig = getattr(mod, name)

    def rec(*args, **kw):
        out = orig(*args, **kw)
        store.append(([np_(a) if hasattr(a, "shape") else a for a in args],
                      {k: np_(v) if hasattr(v, "shape") else v for k, v in kw.items()},
                      [np_(o) for o in out] if isinstance(out, tuple) else np_(out)))
        return out

    monkeypatch.setattr(mod, name, rec)


@pytest.mark.parametrize("back", [3, 6, -1])
def test_geometry_check(session, monkeypatch, back):
    """The last keyframe against one ``back`` keyframes earlier (-1: the
    first keyframe, a quarter circle away)."""
    jlc, plc = session["jlc"], session["plc"]
    order = session["js"].map.keyframe_order
    kid, cid = order[-1], (order[0] if back < 0 else order[-1 - back])
    jr, pr = [], []
    _recorded(monkeypatch, jproc, "sim3_ransac_reproj", jr)
    _recorded(monkeypatch, procrustes, "sim3_ransac_reproj", pr)
    with jax.enable_x64(False):
        ok_r, S_r, n_r = jlc.geometry_check(jlc.map.keyframes[kid], jlc.map.keyframes[cid])
    ok, S, n = plc.geometry_check(plc.map.keyframes[kid], plc.map.keyframes[cid])
    assert ok == ok_r
    assert len(pr) == len(jr)
    if jr:
        # identical BoW matches: the same correspondence sets, bit for bit
        ref_args, got_args = jr[0][0][1:8], pr[0][0][:7]
        for a, b in zip(got_args, ref_args):
            np.testing.assert_array_equal(a, b)
        assert abs(int(pr[0][2][2]) - int(jr[0][2][2])) <= MARGIN
        session["calls"] = session.get("calls", 0) + 1
        assert plc.sampler.calls == session["calls"]
    if ok:
        np.testing.assert_allclose(S, S_r, atol=S_TOL)
        assert abs(n - n_r) <= MARGIN
        session["results"][back] = (kid, cid, S_r)
    if back == 3:
        assert ok, "a keyframe three back shares most of its points"
    if back < 0:
        assert not ok


def test_correct_loop(session, monkeypatch):
    """Correct the accepted pair with its S12 composed with a 1 degree, 0.3 m
    error (so the correction moves the map): poses, points, the pose graph
    and the fused observations against the reference."""
    kid, cid, S_r = session["results"][3]
    jlc, plc = session["jlc"], session["plc"]
    err = np.eye(4)
    c, s = np.cos(np.radians(1.0)), np.sin(np.radians(1.0))
    err[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    err[:3, 3] = [0.3, 0.0, -0.1]
    S12 = err @ S_r
    jg, pg = [], []
    _recorded(monkeypatch, joptim, "pose_graph_optimize", jg)
    _recorded(monkeypatch, optim, "pose_graph_optimize", pg)
    for lc in (jlc, plc):
        monkeypatch.setattr(lc.gba, "dispatch", lambda *a, **k: None)
    jm, pm = jlc.map, plc.map
    before = {k: pm.keyframes[k].Tcw.copy() for k in pm.keyframe_order}
    pos_before = pm.points.pos.copy()
    pgo_args = []
    pgo = plc._essential_graph_pgo

    def recorded_pgo(*args):
        pgo_args.append(args)
        return pgo(*args)

    monkeypatch.setattr(plc, "_essential_graph_pgo", recorded_pgo)
    with jax.enable_x64(False):
        jlc.correct_loop(jm.keyframes[kid], jm.keyframes[cid], S12)
    plc.correct_loop(pm.keyframes[kid], pm.keyframes[cid], S12)
    assert len(jg) == len(pg) == 1
    for k in (1, 2, 3, 5):     # edges, measurements and the fixed vertex
        np.testing.assert_array_equal(pg[0][0][k], jg[0][0][k])
    assert jg[0][2].dtype == np.float32
    np.testing.assert_allclose(pg[0][2], jg[0][2], atol=POSE_TOL)

    def live(m, pts):
        # the JAX map keeps stale slots of dead points, which the import drops
        return np.where((pts >= 0) & m.points.valid[np.clip(pts, 0, None)], pts, -1)

    moved = 0.0
    for k in jm.keyframe_order:
        np.testing.assert_allclose(pm.keyframes[k].Tcw, jm.keyframes[k].Tcw, atol=POSE_TOL)
        np.testing.assert_array_equal(live(pm, pm.keyframes[k].points),
                                      live(jm, jm.keyframes[k].points))
        moved = max(moved, np.abs(pm.keyframes[k].Tcw - before[k]).max())
    assert moved > 0.05, "the correction did not move the map"
    ids = jm.points.alive_ids()
    np.testing.assert_array_equal(pm.points.alive_ids(), ids)
    assert plc.last_pgo_size == (len(jm.keyframe_order), len(jg[0][0][1]))
    # the reference moves every point with its oldest observer after the
    # pose graph; the port moves a point that the group's correction moved
    # with the keyframe that moved it (ORB-SLAM's corrected reference), so
    # such a point keeps its place in that keyframe's camera frame.  The
    # other points are held to the reference.
    corrected_by = pgo_args[0][5]
    departed = np.asarray([p for p in ids if int(p) in corrected_by
                           and corrected_by[int(p)] != min(jm.observations[int(p)])], np.int64)
    assert len(departed) > 0, "no point whose reference keyframe differs"
    same = np.setdiff1d(ids, departed)
    np.testing.assert_allclose(pm.points.pos[same], jm.points.pos[same], atol=POSE_TOL)
    for pid in departed:
        T0, T1 = before[corrected_by[int(pid)]], pm.keyframes[corrected_by[int(pid)]].Tcw
        np.testing.assert_allclose(T1[:3, :3] @ pm.points.pos[pid] + T1[:3, 3],
                                   T0[:3, :3] @ pos_before[pid] + T0[:3, 3], atol=POSE_TOL)


def test_loop_connections(session, monkeypatch):
    """A loop connection (a covisibility link that the loop fusion made
    across the loop) is measured in the essential graph between the
    corrected poses, as the loop edge is; without the mark it keeps its
    pre-correction relative pose, as every edge of the reference's outside
    the group does.  Runs last: it writes the graph's poses into the map."""
    pm = session["plc"].map
    plc = session["plc"]
    kf, cand = pm.keyframes[pm.keyframe_order[-1]], pm.keyframes[pm.keyframe_order[0]]
    b, w = max(((k, w) for k, w in kf.connected_keyframes.items() if k != cand.kid),
               key=lambda kw: kw[1])
    assert w >= 100, "no link strong enough for the essential graph"
    S_old = {k: pm.keyframes[k].Tcw.copy() for k in pm.keyframe_order}
    shift = np.eye(4)
    shift[:3, 3] = [0.5, 0.0, -0.2]
    corrected = {kf.kid: shift @ S_old[kf.kid]}
    edge = (min(kf.kid, b), max(kf.kid, b))
    seen = []

    def pose_graph_optimize(S_init, ei, ej, S_meas, *args, **kw):
        seen.append((np_(ei), np_(ej), np_(S_meas)))
        return S_init

    monkeypatch.setattr(optim, "pose_graph_optimize", pose_graph_optimize)
    for seam in (set(), {edge}):
        plc._essential_graph_pgo(kf, cand, S_old, corrected, seam, {})
    row = {kid: i for i, kid in enumerate(pm.keyframe_order)}
    S = [dict(S_old), {**S_old, **corrected}]
    for (ei, ej, S_meas), poses in zip(seen, S):
        j = int(np.nonzero((ei == row[edge[0]]) & (ej == row[edge[1]]))[0][0])
        np.testing.assert_allclose(S_meas[j], poses[edge[0]] @ np.linalg.inv(poses[edge[1]]),
                                   atol=1e-6)
