"""The system state across the two packages, on one small stereo map per
package: 8 frames of the 240x320 straight-line stream (0.4 m a frame), 300
ORB2 features on 3 levels, the DBOW3 loop detector (its vocabulary tree
trained from the session), built once per module; the JAX session with x64
off, as it runs outside the tests.

Held: the port's native round trip (poses within 1e-12, descriptors,
keypoints, observations, covisibility and spanning tree identical); the
native and the reference schema read by the other package in both
directions (the same counts, poses within 1e-12, descriptors identical);
the AKAZE width (the JAX package restores its 486 bits as 488 columns, the
port trims them back to 486, ROADMAP.md section 3); and the system state
saved by one package and loaded by the other: the loop-closing database
and its vocabulary (checksum equal), the voxel table (slots identical) and
the relocalisation into the loaded map.
"""

import json
import os

import jax
import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu.dense.volumetric_integrator import (
    VolumetricIntegratorType as JaxIntegratorType,
    volumetric_integrator_factory as jax_integrator_factory,
)
from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.loop_closing.vocabulary import BinaryVocabulary as JaxBinaryVocabulary
from pyslam_tpu.loop_closing.vocabulary import HierarchicalVocabulary as JaxHierVocabulary
from pyslam_tpu.slam import map_serialization as jax_ser
from pyslam_tpu.slam import map_serialization_ref as jax_ref
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.slam import Slam as JaxSlam
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.dense.volumetric_integrator import (
    VolumetricIntegratorType,
    volumetric_integrator_factory,
)
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.loop_closing.vocabulary import BinaryVocabulary, HierarchicalVocabulary
from pyslam_tpu_torch.slam import map_serialization as ser
from pyslam_tpu_torch.slam import map_serialization_ref as ref
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from pyslam_tpu_torch.slam.tracking import TrackingState

N_FRAMES = 8
POSE_TOL = 1e-12


def _stream(cls, sensor):
    return cls(num_frames=N_FRAMES, sensor_type=sensor, trajectory="line", step=0.4)


def _cam(cls, ds):
    return cls(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * ds.baseline,
               depth_threshold=20.0)


def _port_slam(cam, **kw):
    return Slam(cam, FeatureTrackerConfig(num_features=300, num_levels=3),
                sensor_type=SensorType.STEREO, device="cpu", **kw)


def _jax_slam(cam, **kw):
    return JaxSlam(cam, JaxTrackerConfig(num_features=300, num_levels=3),
                   sensor_type=JaxSensorType.STEREO, **kw)


def _run(slam, ds):
    for i in range(len(ds)):
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.finish()
    return slam


def _tsdf_state(factory, itype, cam, **kw):
    """An integrator holding one RGBD frame of the stream (frame 0)."""
    ds = _stream(SyntheticDataset, SensorType.RGBD)
    integ = factory(itype.TSDF, camera=cam, **kw)
    Twc = ds.poses[0]
    integ.volume.integrate(ds.getDepth(0), ds.getImage(0), Twc, cam.K)
    return integ


@pytest.fixture(scope="module")
def port():
    ds = _stream(SyntheticDataset, SensorType.STEREO)
    cam = _cam(PinholeCamera, ds)
    slam = _run(_port_slam(cam, loop_detector_config="DBOW3"), ds)
    assert slam.map.num_keyframes() >= 2 and slam.map.num_points() > 100
    slam.set_volumetric_integrator(_tsdf_state(volumetric_integrator_factory,
                                               VolumetricIntegratorType, cam, device="cpu"))
    return ds, cam, slam


@pytest.fixture(scope="module")
def ref_session():
    ds = _stream(JaxSyntheticDataset, JaxSensorType.STEREO)
    cam = _cam(JaxCamera, ds)
    with jax.enable_x64(False):
        slam = _run(_jax_slam(cam, loop_detector_config="DBOW3"), ds)
        slam.set_volumetric_integrator(_tsdf_state(jax_integrator_factory, JaxIntegratorType,
                                                   cam))
    assert slam.map.num_keyframes() >= 2
    return ds, cam, slam


def _same_map(a, b, desc=True, graph=True):
    """Two maps (either package) hold the same keyframes and points."""
    assert a.num_keyframes() == b.num_keyframes() and a.num_points() == b.num_points()
    assert list(a.keyframe_order) == list(b.keyframe_order)
    for kid in a.keyframe_order:
        ka, kb = a.keyframes[kid], b.keyframes[kid]
        np.testing.assert_allclose(kb.Tcw, ka.Tcw, rtol=0, atol=POSE_TOL)
        assert ka.id == kb.id and ka.timestamp == kb.timestamp
        np.testing.assert_array_equal(kb.points, ka.points)
        np.testing.assert_array_equal(np.asarray(kb.kps, np.float32),
                                      np.asarray(ka.kps, np.float32))
        np.testing.assert_array_equal(kb.levels, ka.levels)
        if desc:
            assert kb.des.dtype == ka.des.dtype
            np.testing.assert_array_equal(kb.des, ka.des)
        if graph:
            assert kb.connected_keyframes == ka.connected_keyframes
            assert kb.parent == ka.parent and kb.children == ka.children
    assert a.observations == b.observations
    alive = a.points.alive_ids()
    np.testing.assert_array_equal(b.points.alive_ids(), alive)
    np.testing.assert_allclose(b.points.pos[alive], a.points.pos[alive], rtol=0, atol=POSE_TOL)
    if desc:
        np.testing.assert_array_equal(b.points.desc[alive], a.points.desc[alive])
    np.testing.assert_array_equal(b.points.num_obs[alive], a.points.num_obs[alive])


# ----------------------------------------------------------------- schemas

def test_native_round_trip(port):
    _, cam, slam = port
    d = json.loads(json.dumps(ser.map_to_json(slam.map)))
    m2 = ser.map_from_json(d, slam.feature_tracker, cam)
    _same_map(slam.map, m2)
    np.testing.assert_array_equal(m2.points.normal[slam.map.points.alive_ids()],
                                  slam.map.points.normal[slam.map.points.alive_ids()])
    assert m2.device.type == "cpu"
    assert all(kf.device.type == "cpu" for kf in m2.keyframes.values())
    assert m2.next_kid == slam.map.next_kid
    assert m2.points.size == slam.map.points.size   # new point ids continue


def test_interop_is_the_native_reader(port):
    _, cam, slam = port
    d = ser.map_to_json(slam.map)
    _same_map(slam.map, interop.map_from_tpu_json(d, cam, slam.feature_tracker))


def test_native_port_to_jax(port, ref_session):
    """A port map in the native schema, read by the JAX package."""
    _, _, slam = port
    _, jcam, js = ref_session
    d = json.loads(json.dumps(ser.map_to_json(slam.map)))
    _same_map(slam.map, jax_ser.map_from_json(d, js.feature_tracker, jcam))


def test_native_jax_to_port(port, ref_session):
    """The JAX package's map in the native schema, read by the port."""
    _, cam, slam = port
    _, _, js = ref_session
    d = json.loads(json.dumps(jax_ser.map_to_json(js.map)))
    m = ser.map_from_json(d, slam.feature_tracker, cam)
    _same_map(js.map, m)
    # and the port writes it back byte for byte
    assert json.dumps(ser.map_to_json(m)) == json.dumps(jax_ser.map_to_json(
        jax_ser.map_from_json(d, js.feature_tracker, js.camera)))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_reference_schema_across_packages(direction, port, ref_session):
    _, cam, slam = port
    _, jcam, js = ref_session
    if direction == "jax_to_port":
        src, d = js.map, jax_ref.map_to_reference_json(js.map, jcam)
    else:
        src, d = slam.map, ref.map_to_reference_json(slam.map, cam,
                                                     sensor_type=SensorType.STEREO)
    d = json.loads(json.dumps(d))
    assert ref.is_reference_schema(d) and jax_ref.is_reference_schema(d)
    if direction == "port_to_jax":
        m = jax_ref.map_from_reference_json(d, js.feature_tracker, jcam)
    else:
        m = ref.map_from_reference_json(d, slam.feature_tracker, cam)
        assert m.device.type == "cpu"
    _same_map(src, m)


def test_reference_schema_writer_matches_reference(port, ref_session):
    """The port's reference-schema document of a map equals the JAX
    package's document of the same map (loaded from the port's native
    JSON)."""
    _, cam, slam = port
    _, jcam, js = ref_session
    jm = jax_ser.map_from_json(json.loads(json.dumps(ser.map_to_json(slam.map))),
                               js.feature_tracker, jcam)
    dp = ref.map_to_reference_json(slam.map, cam)
    dj = jax_ref.map_to_reference_json(jm, jcam)
    for kp, kj in zip(dp["map"]["keyframes"], dj["map"]["keyframes"]):
        for key in ("id", "kid", "pose", "kps", "octaves", "des", "points", "parent",
                    "children", "connected_keyframes_weights", "camera"):
            assert kp[key] == kj[key], key
    assert [p["des"] for p in dp["map"]["points"]] == [p["des"] for p in dj["map"]["points"]]
    # the same observations (a live map lists them in insertion order, a
    # loaded one in keyframe order)
    assert [sorted(p["_observations"]) for p in dp["map"]["points"]] == \
        [sorted(p["_observations"]) for p in dj["map"]["points"]]


# ----------------------------------------------------------------- AKAZE

@pytest.mark.parametrize("schema", ["native", "reference"])
def test_akaze_width(schema, port, ref_session):
    """486-bit M-LDB descriptors through the bit-packed schemas: the JAX
    package reads them back as 488 columns (np.unpackbits pads to whole
    bytes) and its store adopts 488; the port trims them to its AKAZE
    tracker's 486 bits, which are the bits written."""
    _, cam, slam = port
    _, jcam, js = ref_session
    m = ser.map_from_json(json.loads(json.dumps(ser.map_to_json(slam.map))),
                          slam.feature_tracker, cam)
    r = np.random.default_rng(5)
    for kf in m.keyframes.values():
        kf.des = r.integers(0, 2, (kf.num_kps, 486)).astype(np.int8)
    alive = m.points.alive_ids()
    m.points.desc = np.zeros((m.points.capacity, 486), np.int8)
    m.points.desc[alive] = r.integers(0, 2, (len(alive), 486)).astype(np.int8)
    if schema == "native":
        d = json.loads(json.dumps(ser.map_to_json(m)))
        jm = jax_ser.map_from_json(d, js.feature_tracker, jcam)
        load = ser.map_from_json
    else:
        d = json.loads(json.dumps(ref.map_to_reference_json(m, cam)))
        jm = jax_ref.map_from_reference_json(d, js.feature_tracker, jcam)
        load = ref.map_from_reference_json
    kid = m.keyframe_order[0]
    assert jm.keyframes[kid].des.shape[1] == 488 and jm.points.desc.shape[1] == 488
    np.testing.assert_array_equal(jm.keyframes[kid].des[:, :486], m.keyframes[kid].des)
    assert not jm.keyframes[kid].des[:, 486:].any()
    akaze = feature_tracker_factory("AKAZE", device="cpu")
    pm = load(d, akaze, cam)
    assert pm.points.desc.shape[1] == 486
    for k in m.keyframe_order:
        np.testing.assert_array_equal(pm.keyframes[k].des, m.keyframes[k].des)
    np.testing.assert_array_equal(pm.points.desc[alive], m.points.desc[alive])
    # a tracker whose width is a whole number of bytes keeps every column
    assert load(d, slam.feature_tracker, cam).points.desc.shape[1] == 488


# ------------------------------------------------------------ vocabularies

@pytest.mark.parametrize("kind", ["tree_bits", "tree_float", "flat_bits", "flat_float"])
def test_vocabulary_files_across_packages(kind, tmp_path):
    """A vocabulary trained from the same descriptors with the same seed is
    the JAX package's; each package loads the other's file (a tree with the
    same checksum)."""
    r = np.random.default_rng(2)
    is_float = kind.endswith("float")
    desc = (r.normal(size=(600, 32)).astype(np.float32) if is_float
            else r.integers(0, 2, (600, 256)).astype(np.int8))
    with jax.enable_x64(False):
        if kind.startswith("tree"):
            vj, vp = JaxHierVocabulary(branching=4, depth=3), HierarchicalVocabulary(
                branching=4, depth=3, device="cpu")
        else:
            vj, vp = JaxBinaryVocabulary(num_words=64), BinaryVocabulary(num_words=64,
                                                                         device="cpu")
        vj.seed_from_descriptors(desc)
        vp.seed_from_descriptors(desc)
        pj, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
        vj.save(pj)
        vp.save(pp)
        from_jax = type(vp).load(pj, device="cpu")
        from_port = type(vj).load(pp)
    if kind.startswith("tree"):
        assert vp.checksum() == vj.checksum() == from_jax.checksum() == from_port.checksum()
        np.testing.assert_array_equal(from_jax.centroids, vj.centroids)
        np.testing.assert_array_equal(from_port.node_word, vp.node_word)
    else:
        np.testing.assert_array_equal(from_jax.words_bits, vj.words_bits)
        np.testing.assert_array_equal(from_port.words_bits, vp.words_bits)
    assert from_jax.seeded and from_jax.device.type == "cpu"
    valid = np.ones(len(desc), bool)
    np.testing.assert_array_equal(from_jax.words_for(desc, valid), vp.words_for(desc, valid))


# ----------------------------------------------------------- system state

def _same_db(a, b):
    assert set(a.kf_gdes) == set(b.kf_gdes) and len(a.kf_gdes) > 0
    for kid in a.kf_gdes:
        np.testing.assert_array_equal(np.asarray(b.kf_gdes[kid]), np.asarray(a.kf_gdes[kid]))
        np.testing.assert_array_equal(b.kf_words[kid], a.kf_words[kid])
        np.testing.assert_array_equal(b.kf_kp_words[kid], a.kf_kp_words[kid])
    assert dict(a.inverted) == dict(b.inverted)


def _table(vol):
    keys = vol._np("keys") if hasattr(vol, "_np") else np.asarray(vol.table.keys)
    occ = vol._np("occupied") if hasattr(vol, "_np") else np.asarray(vol.table.occupied)
    tsdf = vol._np("tsdf") if hasattr(vol, "_np") else np.asarray(vol.table.tsdf)
    return keys, occ, tsdf


def test_jax_state_loaded_by_port(port, ref_session, tmp_path):
    """The JAX package's saved state (native map, loop-closing DB with its
    tree, voxel table) loaded by the port: the same map, database and
    table, the checksum equal, every part on the session's device, and the
    session relocalises in it."""
    ds, cam, _ = port
    _, _, js = ref_session
    path = str(tmp_path / "state")
    with jax.enable_x64(False):
        js.save_system_state(path)
    assert sorted(os.listdir(path)) == ["config_info.json", "loop_closing_state.npz",
                                        "loop_vocabulary.npz", "map.json",
                                        "volumetric_state.npz"]
    slam = _port_slam(cam, loop_detector_config="DBOW3")
    integ = volumetric_integrator_factory(VolumetricIntegratorType.TSDF, camera=cam,
                                          device="cpu")
    slam.set_volumetric_integrator(integ)
    slam.load_system_state(path)
    _same_map(js.map, slam.map)
    lc, jlc = slam.loop_closing, js.loop_closing
    _same_db(jlc.db, lc.db)
    saved = str(np.load(os.path.join(path, "loop_closing_state.npz"))["voc_checksum"])
    assert lc.detector.vocabulary.checksum() == jlc.detector.vocabulary.checksum() == saved
    assert lc.detector._trained and lc.detector.vocabulary.device.type == "cpu"
    for a, b in zip(_table(integ.volume), _table(js.volumetric_integrator.volume)):
        np.testing.assert_array_equal(a, b)
    assert slam.state == TrackingState.INIT_RELOCALIZE
    assert slam.tracking.kf_ref is slam.map.last_keyframe()
    states = []
    for i in range(2, 6):
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=100 + i,
                   timestamp=10.0 + ds.getTimestamp(i))
        states.append(slam.state.name)
    assert "OK" in states, states


@pytest.mark.parametrize("schema", ["native", "reference"])
def test_port_state_loaded_by_jax(schema, port, ref_session, tmp_path):
    """The port's saved state loaded by the JAX package: the same map (in
    either schema), database, tree checksum and voxel table."""
    _, cam, slam = port
    _, jcam, _ = ref_session
    path = str(tmp_path / "state")
    slam.save_system_state(path, schema=schema)
    info = json.load(open(os.path.join(path, "config_info.json")))
    assert info == {"sensor_type": "STEREO", "num_keyframes": slam.map.num_keyframes(),
                    "num_points": slam.map.num_points()}
    with jax.enable_x64(False):
        js = _jax_slam(jcam, loop_detector_config="DBOW3")
        jinteg = jax_integrator_factory(JaxIntegratorType.TSDF, camera=jcam)
        js.set_volumetric_integrator(jinteg)
        js.load_system_state(path)
    _same_map(slam.map, js.map, graph=schema == "native")
    _same_db(slam.loop_closing.db, js.loop_closing.db)
    assert js.loop_closing.detector.vocabulary.checksum() == \
        slam.loop_closing.detector.vocabulary.checksum()
    for a, b in zip(_table(slam.volumetric_integrator.volume), _table(jinteg.volume)):
        np.testing.assert_array_equal(a, b)


def test_port_state_round_trip_and_reset(port, tmp_path):
    """The port's own state round trip: counts, the DB and the table; a
    reset after it clears the map and the queues; an unknown schema is
    refused."""
    _, cam, slam = port
    path = str(tmp_path / "state")
    slam.save_system_state(path)
    s2 = _port_slam(cam, loop_detector_config="DBOW3")
    integ = volumetric_integrator_factory(VolumetricIntegratorType.TSDF, camera=cam,
                                          device="cpu")
    s2.set_volumetric_integrator(integ)
    s2.load_system_state(path)
    _same_map(slam.map, s2.map)
    _same_db(slam.loop_closing.db, s2.loop_closing.db)
    assert integ.volume.num_voxels() == slam.volumetric_integrator.volume.num_voxels() > 0
    ts, poses = s2.get_keyframe_trajectory()
    assert len(ts) == s2.map.num_keyframes() and poses.shape == (len(ts), 4, 4)
    assert s2.local_mapping._kf_store is None and not s2.local_mapping.queue
    s2.reset()
    assert s2.map.num_keyframes() == 0 and s2.loop_closing.map is s2.map
    assert integ.volume.num_voxels() == 0
    with pytest.raises(ValueError):
        slam.save_system_state(str(tmp_path / "bad"), schema="bogus")


def test_load_refuses_a_state_off_the_session_device(port, tmp_path, monkeypatch):
    """A load that leaves a part of the state on another device raises
    instead of running on: here the vocabulary is built on the wrong one."""
    _, cam, slam = port
    path = str(tmp_path / "state")
    slam.save_system_state(path)
    s2 = _port_slam(cam, loop_detector_config="DBOW3")
    real = HierarchicalVocabulary.load

    def elsewhere(p, *, device="cuda"):
        v = real(p, device="cpu")
        v.device = __import__("torch").device("meta")
        return v

    monkeypatch.setattr(HierarchicalVocabulary, "load", staticmethod(elsewhere))
    with pytest.raises(RuntimeError, match="device"):
        s2.load_system_state(path)


def test_bundle_adjust_on_a_loaded_map(port, tmp_path):
    """``Slam.bundle_adjust`` on a reloaded map: a finite cost, the first
    keyframe held (the gauge), and the keyframe trajectory
    (``get_keyframe_trajectory``) within the 0.25 m ATE floor of
    tests/test_slam_e2e.py against the ground truth."""
    from pyslam_tpu_torch.evaluation.metrics import eval_ate

    ds, cam, slam = port
    path = str(tmp_path / "state")
    slam.save_system_state(path)
    s2 = _port_slam(cam)
    s2.load_system_state(path)
    first = s2.map.keyframe_order[0]
    T0 = s2.map.keyframes[first].Tcw.copy()
    cost = s2.bundle_adjust(iters=5)
    assert np.isfinite(cost) and cost >= 0.0
    np.testing.assert_array_equal(s2.map.keyframes[first].Tcw, T0)
    ts, Twc = s2.get_keyframe_trajectory()
    gt_t = np.array([ds.getTimestamp(i) for i in range(len(ds))])
    res = eval_ate(ts, Twc[:, :3, 3], gt_t, ds.poses[:, :3, 3], align=True, with_scale=False)
    assert res.num_pairs == s2.map.num_keyframes() and res.rmse < 0.25, res
