"""The port's native observation graph (``pyslam_tpu_torch/native``) and the
map bookkeeping built on it, against the JAX package's
(``pyslam_tpu/native``, ``pyslam_tpu/slam/map.py``).

Both packages keep the observations in host dicts and mirror them into the
same C++ graph (libstdc++ ``unordered_map``s), whose iteration order sets
the order of the local and global BA edge lists and of the covisibility
counter.  The maps here are built by the same add / remove / replace /
delete / cull sequence in both packages; edge lists, covisibility order
and spanning-tree parents must be identical, not merely equal as sets."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu import native as jnative
from pyslam_tpu.slam import frame as jframe
from pyslam_tpu.slam import global_bundle_adjustment as jgba
from pyslam_tpu.slam import local_mapping as jlm
from pyslam_tpu.slam import map as jmap
from pyslam_tpu_torch.slam import frame as tframe
from pyslam_tpu_torch.slam import global_bundle_adjustment as tgba
from pyslam_tpu_torch.slam import local_mapping as tlm
from pyslam_tpu_torch.slam import map as tmap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLOTS = 80
SIGMA2 = np.array([1.0, 1.44, 2.0736, 2.985984], np.float32)
K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])


def _keyframe(cls, kid, data):
    """A bare keyframe of ``cls`` (either package's) carrying what the map
    bookkeeping and the BA assembly read."""
    kf = object.__new__(cls)
    kf.kid = kid
    kf.points = np.full(N_SLOTS, -1, np.int64)
    kf.kps, kf.kps_ur, kf.levels, kf.Tcw = (x.copy() for x in data)
    kf.connected_keyframes, kf.ordered_neighbors = {}, []
    kf.parent, kf.children, kf.loop_edges = None, set(), set()
    kf.is_bad = False
    kf._dev = {}
    return kf


def _build_map(pkg, seed=0, n_kfs=9, n_pts=220):
    """The same operation sequence on either package's Map: observations
    added in a shuffled keyframe order, then removals, replacements, point
    deletions, connections and a keyframe cull."""
    r = np.random.default_rng(seed)
    Map, KeyFrame = (jmap.Map, jframe.KeyFrame) if pkg == "jax" else (tmap.Map, tframe.KeyFrame)
    m = Map() if pkg == "jax" else Map(device="cpu")
    for kid in range(n_kfs):
        data = (r.uniform(0, 600, (N_SLOTS, 2)).astype(np.float32),
                np.where(r.uniform(size=N_SLOTS) < 0.5, -1.0,
                         r.uniform(0, 600, N_SLOTS)).astype(np.float32),
                r.integers(0, 4, N_SLOTS), np.eye(4))
        data[3][:3, 3] = [0.3 * kid, 0.0, 0.0]
        m.add_keyframe(_keyframe(KeyFrame, kid, data))
    pids = m.points.new_points(n_pts)
    m.points.valid[pids] = True
    m.points.pos[pids] = r.uniform(-3, 3, (n_pts, 3)) + [0, 0, 8]
    free = {kid: list(r.permutation(N_SLOTS)) for kid in range(n_kfs)}
    for pid in pids:
        for kid in r.choice(n_kfs, r.integers(1, 6), replace=False):
            if free[int(kid)]:
                m.add_observation(int(pid), m.keyframes[int(kid)], int(free[int(kid)].pop()))
    for _ in range(40):
        pid = int(r.choice(pids))
        obs = m.observations.get(pid)
        if obs:
            m.remove_observation(pid, int(r.choice(sorted(obs))))
    for _ in range(15):
        a, b = (int(x) for x in r.choice(pids, 2, replace=False))
        if m.points.valid[a] and m.points.valid[b]:
            m.replace_point(a, b)
    for pid in r.choice(pids, 6, replace=False):
        if m.points.valid[int(pid)]:
            m.delete_point(int(pid))
    for kid in list(m.keyframe_order):
        m.update_connections(m.keyframes[kid], min_weight=3)
    m.remove_keyframe(m.keyframes[4])
    for kid in list(m.keyframe_order)[-3:]:
        m.update_connections(m.keyframes[kid], min_weight=3)
    return m


def _lba_edges(pkg, m):
    lm = jlm.LocalMapping if pkg == "jax" else tlm.LocalMapping
    host = SimpleNamespace(map=m, tracker=SimpleNamespace(sigma2=SIGMA2), semantic_mapping=None)
    all_kids = list(m.keyframe_order)[1:6]
    local_pids = m.get_local_map_points(all_kids)
    kid_to_row = {k: i for i, k in enumerate(all_kids)}
    out = lm._collect_ba_observations(host, local_pids, kid_to_row, all_kids)
    return [np.asarray(a) for a in out]


def _gba_edges(pkg, m):
    cam = SimpleNamespace(K=K, bf=40.0)
    tracker = SimpleNamespace(sigma2=SIGMA2)
    if pkg == "jax":
        prob, kids, pids = jgba.build_full_problem(m, cam, tracker)
    else:
        prob, kids, pids = tgba.build_full_problem(m, cam, tracker, device="cpu")
    return [np.asarray(getattr(prob, f)) for f in ("cam_idx", "pt_idx", "uv", "ur", "sigma2")]


def _tie_map(pkg):
    """Keyframe 3 shares 20 points with keyframe 1 (observed first) and 20
    with keyframe 2: its counter ties, and the order the counter is walked
    in picks the parent."""
    Map, KeyFrame = (jmap.Map, jframe.KeyFrame) if pkg == "jax" else (tmap.Map, tframe.KeyFrame)
    m = Map() if pkg == "jax" else Map(device="cpu")
    z = np.zeros((N_SLOTS, 2), np.float32)
    for kid in range(4):
        m.add_keyframe(_keyframe(KeyFrame, kid, (z, z[:, 0], np.zeros(N_SLOTS, int), np.eye(4))))
    pids = m.points.new_points(40)
    m.points.valid[pids] = True
    for j, pid in enumerate(pids):
        m.add_observation(int(pid), m.keyframes[1 if j < 20 else 2], j)
        m.add_observation(int(pid), m.keyframes[3], j)
    m.update_connections(m.keyframes[3])
    return m


def test_edge_order_matches_the_reference():
    """The LBA and GBA edge lists and the covisibility order of the port
    equal the reference's, row for row, on the same map."""
    jm, tm = _build_map("jax"), _build_map("port")
    assert jm._native is not None, "the JAX package's native mirror must be built"
    for got, want in zip(_lba_edges("port", tm), _lba_edges("jax", jm)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_gba_edges("port", tm), _gba_edges("jax", jm)):
        np.testing.assert_array_equal(got, want)
    for kid in jm.keyframe_order:
        a, b = jm.keyframes[kid], tm.keyframes[kid]
        assert list(b.connected_keyframes.items()) == list(a.connected_keyframes.items()), kid
        assert b.ordered_neighbors == a.ordered_neighbors and b.parent == a.parent, kid
    jt, tt = _tie_map("jax"), _tie_map("port")
    a, b = jt.keyframes[3], tt.keyframes[3]
    assert list(a.connected_keyframes.values()) == [20, 20]
    assert list(b.connected_keyframes.items()) == list(a.connected_keyframes.items())
    assert b.parent == a.parent


def _mirror_matches_dicts(m):
    """The map's native mirror holds exactly its dicts' observations, and
    the native counter and edge list equal their dict loops as sets."""
    obs = {p: o for p, o in m.observations.items() if o}
    assert m._native.total_observations() == sum(len(o) for o in obs.values())
    pids = np.asarray(sorted(obs), np.int64)
    got = set(zip(*(a.tolist() for a in m.collect_observations(pids))))
    assert got == set(zip(*(a.tolist() for a in m.collect_observations_plain(pids))))
    for kid, kf in m.keyframes.items():
        kp = kf.points[kf.points >= 0]
        assert m.covisibility_counts(kp, kid) == m.covisibility_counts_plain(kp, kid)
    for pid in pids[:: max(1, len(pids) // 50)]:
        assert m._native.point_obs(int(pid)) == obs[int(pid)]


def test_map_mirror_matches_its_dicts():
    _mirror_matches_dicts(_build_map("port", seed=1))


def test_obs_graph_basic():
    """The reference's basic case (tests/test_native.py) on the port's graph."""
    from pyslam_tpu_torch import native

    g = native.NativeObsGraph()
    assert g.add_observation(10, 1, 5)
    assert not g.add_observation(10, 1, 7)
    assert g.add_observation(10, 2, 9)
    assert g.num_obs(10) == 2 and g.point_obs(10) == {1: 5, 2: 9}
    assert g.remove_observation(10, 1) == 5
    assert g.num_obs(10) == 1 and g.remove_observation(10, 1) == -1


def _graph_state(g, pids, kids):
    return ([list(g.point_obs(int(p)).items()) for p in pids],
            [list(g.covisibility_counts(pids, int(k)).items()) for k in kids],
            [a.tolist() for a in g.collect_observations(pids)],
            [g.points_seen_by(int(k)).tolist() for k in kids],
            [g.num_obs(int(p)) for p in pids], g.total_observations())


@pytest.mark.parametrize("seed", [0, 1])
def test_obs_graph_matches_the_reference(seed):
    """The same random sequence of additions, removals, point removals,
    replacements and a keyframe cull on both packages' graphs: every
    return value and every query identical, in order."""
    from pyslam_tpu_torch import native

    r = np.random.default_rng(seed)
    graphs = (jnative.NativeObsGraph(), native.NativeObsGraph())
    n_pts, n_kfs = 300, 20
    pids = np.arange(n_pts, dtype=np.int64)
    kids = np.arange(n_kfs)

    def both(name, *args):
        outs = [getattr(g, name)(*args) for g in graphs]
        assert outs[0] == outs[1], (name, args, outs)

    for pid in pids:
        for kid in r.choice(n_kfs, r.integers(1, 7), replace=False):
            both("add_observation", int(pid), int(kid), int(r.integers(0, 500)))
    assert _graph_state(graphs[0], pids, kids) == _graph_state(graphs[1], pids, kids)
    for _ in range(120):
        both("remove_observation", int(r.integers(0, n_pts)), int(r.integers(0, n_kfs)))
    for pid in r.choice(n_pts, 25, replace=False):
        both("remove_point", int(pid))
    for _ in range(20):   # replace: the old point's observations move to the new
        old, new = (int(x) for x in r.choice(n_pts, 2, replace=False))
        moved = graphs[1].point_obs(old)
        both("remove_point", old)
        for kid, kp in moved.items():
            both("add_observation", new, kid, kp)
    cull = int(r.integers(1, n_kfs))
    for pid in graphs[1].points_seen_by(cull):
        both("remove_observation", int(pid), cull)
    assert _graph_state(graphs[0], pids, kids) == _graph_state(graphs[1], pids, kids)


def test_buffers_are_not_cut():
    """Where the reference's wrapper cuts its result (32 observations a
    point in an edge list, 1024 in ``point_obs``, 4096 keyframes in a
    count), the port's returns every entry."""
    from pyslam_tpu_torch import native

    g = native.NativeObsGraph()
    for kid in range(5000):
        g.add_observation(7, kid, kid % 97)
    g.add_observation(8, 3, 1)
    rows, kd, kp = g.collect_observations(np.array([8, 7], np.int64))
    assert len(rows) == 5001 and sorted(kd[rows == 1].tolist()) == list(range(5000))
    assert g.point_obs(7) == {kid: kid % 97 for kid in range(5000)}
    counts = g.covisibility_counts(np.array([7, 8], np.int64), exclude_kid=4999)
    assert len(counts) == 4999 and counts[3] == 2 and sum(counts.values()) == 5000
    for kid in range(5000):
        g.add_observation(100 + kid, 0, kid)
    assert sorted(g.points_seen_by(0).tolist()) == [7] + list(range(100, 5100))


def test_hamming_matches_the_reference():
    from pyslam_tpu_torch import native

    r = np.random.default_rng(0)
    a = r.integers(0, 256, (40, 32), dtype=np.uint8)
    b = r.integers(0, 256, (50, 32), dtype=np.uint8)
    got = native.hamming_distance_matrix_cpu(a, b)
    np.testing.assert_array_equal(got, jnative.hamming_distance_matrix_cpu(a, b))
    want = np.stack([np.unpackbits(a[i][None] ^ b, axis=1).sum(1) for i in range(40)])
    np.testing.assert_array_equal(got, want)
    odd = r.integers(0, 256, (7, 61), dtype=np.uint8)   # a tail past the 8-byte words
    np.testing.assert_array_equal(native.hamming_distance_matrix_cpu(odd, odd[:3]),
                                  jnative.hamming_distance_matrix_cpu(odd, odd[:3]))


def test_map_mirror_after_a_session_and_reload(tmp_path):
    """After a short stereo session the map's mirror equals its dicts, and
    so does the mirror of a map reloaded from either schema, also where a
    keyframe names one point in two slots (the lower slot kept)."""
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    ds = SyntheticDataset(num_frames=6, sensor_type=SensorType.STEREO, trajectory="line",
                          step=0.45)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=20.0)
    cfg = FeatureTrackerConfig(num_features=300, num_levels=3)
    slam = Slam(cam, cfg, sensor_type=SensorType.STEREO, device="cpu")
    for i in range(len(ds)):
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.local_mapping.finish()
    assert slam.map.num_keyframes() >= 2
    _mirror_matches_dicts(slam.map)
    total = slam.map._native.total_observations()
    kf = slam.map.keyframes[slam.map.keyframe_order[-1]]
    slot = int(np.nonzero(kf.points >= 0)[0][-1])
    pid = int(kf.points[slot])
    free = int(np.nonzero(kf.points < 0)[0][0])
    kf.points[free] = pid   # the same point in a second slot
    for schema in ("native", "reference"):
        path = str(tmp_path / schema)
        slam.save_system_state(path, schema=schema)
        s2 = Slam(cam, cfg, sensor_type=SensorType.STEREO, device="cpu")
        s2.load_system_state(path)
        _mirror_matches_dicts(s2.map)
        assert s2.map._native.total_observations() == total, schema
        assert s2.map.observations[pid][kf.kid] == min(slot, free)


def test_concurrent_builds_leave_one_library(tmp_path):
    """Two processes building the library into one folder at once end with
    one loadable library and no partial file."""
    code = ("import ctypes, sys\n"
            "from pyslam_tpu_torch import native\n"
            "ctypes.CDLL(native.build(sys.argv[1]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(libs) == 1 and not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    import ctypes

    from pyslam_tpu_torch import native

    assert os.path.join(str(tmp_path), libs[0]) == native.library_path(str(tmp_path))
    ctypes.CDLL(native.library_path(str(tmp_path))).og_create
