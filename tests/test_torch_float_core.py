"""Float and non-256-bit descriptors through the SLAM core of the port,
against the JAX package: the map's descriptor layout, the float flat and
tree vocabularies, projection search / epipolar matching / fuse with float
descriptors, the stereo row match of an extractor without a fused stereo
path, and relocalisation and the loop geometry check on a ROOT_SIFT map.

The map: the JAX ``Slam`` (x64 off, as it runs outside this suite) tracks
8 frames of the 240x320 stereo line stream with the ROOT_SIFT preset; the
map is carried across with ``interop.map_from_tpu_json``.

Tolerances:
- match indices, vocabulary words and trees, layouts: identical (float
  descriptors here are far from ties: no argmin gap is below 1e-4 where
  float32 noise is ~1e-7);
- float k-means centroids within 1e-6 (the port sums each cluster in the
  reference's row order; the division is the same);
- the row stereo match's right u and depth within 1e-5 relative;
- relocalised pose within 5e-3 and the geometry check's S12 within 2e-4,
  with +-2 inliers, as the ORB2 tests of the same stages state
  (test_torch_relocalizer.py, test_torch_loop_closing.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slam_matching import IB, K, SF, SIG2, _j, _map, _t
from tests.torch_parity import JaxKeySampler, np_, rng, t

from pyslam_tpu.features.tracker import FeatureTrackerConfigs as JaxPresets
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.loop_closing import vocabulary as jvoc
from pyslam_tpu.loop_closing.keyframe_database import KeyFrameDatabase as JaxDB
from pyslam_tpu.loop_closing.loop_closing import LoopClosing as JaxLoopClosing
from pyslam_tpu.loop_closing.loop_closing import LoopDetector as JaxDetector
from pyslam_tpu.loop_closing.loop_detector_configs import LoopDetectorConfigs as JaxConfigs
from pyslam_tpu.loop_closing.relocalizer import Relocalizer as JaxRelocalizer
from pyslam_tpu.ops import lie as jlie
from pyslam_tpu.ops import slam_matching as jsm
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.frame import Frame as JaxFrame
from pyslam_tpu.slam.map import MapPointStorage as JaxStorage
from pyslam_tpu.slam.map_serialization import map_to_json
from pyslam_tpu.slam.slam import Slam as JaxSlam
from pyslam_tpu_torch.features.tracker import feature_tracker_factory
from pyslam_tpu_torch.interop import map_from_tpu_json
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.loop_closing import vocabulary as tvoc
from pyslam_tpu_torch.loop_closing.keyframe_database import KeyFrameDatabase
from pyslam_tpu_torch.loop_closing.loop_closing import LoopClosing, LoopDetector
from pyslam_tpu_torch.loop_closing.loop_detector_configs import LoopDetectorConfigs
from pyslam_tpu_torch.loop_closing.relocalizer import Relocalizer
from pyslam_tpu_torch.ops import slam_matching as tsm
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.frame import Frame
from pyslam_tpu_torch.slam.map import MapPointStorage
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

N_FRAMES = 8
RELOC_TOL = 5e-3
S_TOL = 2e-4
MARGIN = 2


def _unit(r, n, d=128):
    x = np.abs(r.normal(size=(n, d))).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ----------------------------------------------------------- map layout
@pytest.mark.parametrize("dim,dtype", [(256, np.int8), (486, np.int8), (512, np.int8),
                                       (128, np.float32), (64, np.float32)])
def test_ensure_desc_layout(dim, dtype):
    des = np.ones((5, dim), dtype)
    stores = [JaxStorage(16), MapPointStorage(16)]
    for st in stores:
        st.ensure_desc_layout(des)
        ids = st.new_points(40)             # grows past the initial capacity
        st.desc[ids] = 1
    ref, got = stores
    assert got.desc.shape == ref.desc.shape and got.desc.dtype == ref.desc.dtype == dtype
    assert got.desc.shape[1] == dim and got.capacity == ref.capacity


# ----------------------------------------------------------- vocabularies
@pytest.mark.parametrize("seed", [0, 1])
def test_float_flat_vocabulary(seed):
    """Seed (Gaussian jitter of sampled descriptors), mean-centroid k-means
    and L2 quantisation of the flat codebook, with DBOW3_INDEPENDENT's
    calls: self-seeded from the first frame, trained on a larger buffer."""
    r = rng(seed)
    first, buf, query = _unit(r, 300), _unit(r, 1200), _unit(r, 400)
    valid = r.uniform(size=400) > 0.1
    with jax.enable_x64(False):
        jv = jvoc.BinaryVocabulary(num_words=256)
        jv.seed_from_descriptors(first)
        seeded = np.asarray(jv.words_bits).copy()
        jv.train_kmeans(buf)
        ref_words = jv.words_for(jnp.asarray(query), jnp.asarray(valid))
    tv = tvoc.BinaryVocabulary(num_words=256, device="cpu")
    tv.seed_from_descriptors(first)      # jitter, then 2 k-means rounds
    assert np.abs(tv.words_bits - seeded).max() < 1e-6
    tv.train_kmeans(buf)
    assert tv.words_bits.dtype == np.float32
    assert np.abs(tv.words_bits - np.asarray(jv.words_bits)).max() < 1e-6
    got_words = tv.words_for(t(query), t(valid))
    assert np.array_equal(got_words, np.asarray(ref_words))
    assert len(np.unique(got_words[valid])) > 20


def test_float_seed_without_kmeans():
    """Fewer descriptors than num_words // 4: the jittered samples only
    (host numpy with the same generator: identical)."""
    desc = _unit(rng(5), 40)
    jv = jvoc.BinaryVocabulary(num_words=256)
    jv.seed_from_descriptors(desc)
    tv = tvoc.BinaryVocabulary(num_words=256, device="cpu")
    tv.seed_from_descriptors(desc)
    assert np.array_equal(tv.words_bits, np.asarray(jv.words_bits))


def test_float_tree_vocabulary():
    r = rng(3)
    train, query = _unit(r, 600), _unit(r, 300)
    valid = np.ones(300, bool)
    jv = jvoc.HierarchicalVocabulary(branching=4, depth=3, seed=9)
    jv.seed_from_descriptors(train)
    tv = tvoc.HierarchicalVocabulary(branching=4, depth=3, seed=9, device="cpu")
    tv.seed_from_descriptors(train)
    for f in ("centroids", "children", "node_word", "word_level_node"):
        np.testing.assert_array_equal(getattr(tv, f), getattr(jv, f))
    assert tv.centroids.dtype == np.float32
    with jax.enable_x64(False):
        ref = np.asarray(jv.words_for(jnp.asarray(query), jnp.asarray(valid)))
    assert np.array_equal(tv.words_for(t(query), t(valid)), ref)


# ------------------------------------------------------- slam matching
def _float_map(seed):
    """test_torch_slam_matching's map with float descriptors: each point a
    unit 128-vector, its keypoint the vector plus noise, clutter random."""
    pt_side, kp_side, T = _map(seed)
    r = rng(seed + 100)
    m, n = len(pt_side[0]), len(kp_side[0])
    pdesc = _unit(r, m)
    # a keypoint that saw a point carries its bits (6 % flipped): find its
    # point by the Hamming distance, ~15 against ~128 for any other
    kdesc = _unit(r, n)
    ham = (kp_side[2][:, None, :] != pt_side[1][None, :, :]).sum(-1)
    src = np.argmin(ham, 1)
    seen = ham[np.arange(n), src] < 50
    noisy = pdesc[src] + 0.05 * _unit(r, n)
    kdesc[seen] = (noisy / np.linalg.norm(noisy, axis=1, keepdims=True))[seen]
    pt_side[1], kp_side[2] = pdesc, kdesc.astype(np.float32)
    return pt_side, kp_side, T


@pytest.mark.parametrize("seed", [0, 1])
def test_float_search_by_projection(seed):
    pt_side, kp_side, T = _float_map(seed)
    with jax.enable_x64(False):
        ref = jsm.search_by_projection(*_j(pt_side), *_j(kp_side), jnp.asarray(T),
                                       jnp.asarray(K), jnp.asarray(IB), jnp.asarray(SF),
                                       7.0, 0.45, ratio=0.9)
    got = tsm.search_by_projection(*_t(pt_side), *_t(kp_side), t(T), t(K), t(IB), t(SF),
                                   7.0, 0.45, ratio=0.9)
    for a, b in zip(ref, got):
        assert np.array_equal(np_(b), np.asarray(a))
    assert (np.asarray(ref[1]) >= 0).sum() > 50


def test_one_level_search_by_projection():
    """A one-level extractor (SURF, Shi-Tomasi): the reference's gather of
    the second scale factor clamps to the first, every level predicts 0."""
    pt_side, kp_side, T = _float_map(2)
    kp_side[1] = np.zeros_like(kp_side[1])
    sf = np.ones(1, np.float32)
    with jax.enable_x64(False):
        ref = jsm.search_by_projection(*_j(pt_side), *_j(kp_side), jnp.asarray(T),
                                       jnp.asarray(K), jnp.asarray(IB), jnp.asarray(sf),
                                       7.0, 0.45, ratio=0.9)
    got = tsm.search_by_projection(*_t(pt_side), *_t(kp_side), t(T), t(K), t(IB), t(sf),
                                   7.0, 0.45, ratio=0.9)
    for a, b in zip(ref, got):
        assert np.array_equal(np_(b), np.asarray(a))
    assert (np.asarray(ref[1]) >= 0).sum() > 50


@pytest.mark.parametrize("seed", [0, 1])
def test_float_fuse_candidates(seed):
    pt_side, kp_side, T = _float_map(seed)
    with jax.enable_x64(False):
        ref_kp, _ = jsm.fuse_candidates(
            *_j(pt_side), *_j(kp_side), jnp.asarray(T), jnp.asarray(K),
            jnp.asarray(np.float32(40.0)), jnp.asarray(IB), jnp.asarray(SF),
            jnp.asarray(SIG2), 0.45)
    got_kp, _ = tsm.fuse_candidates(
        *[x[None] for x in _t(pt_side)], *[x[None] for x in _t(kp_side)], t(T)[None], t(K),
        torch.tensor(40.0), t(IB), t(SF), t(SIG2), 0.45)
    assert np.array_equal(np_(got_kp[0]), np.asarray(ref_kp))
    assert (np.asarray(ref_kp) >= 0).sum() > 20


def test_float_epipolar_match():
    from pyslam_tpu.ops.geometry import fundamental_np

    r = rng(11)
    pt_side, kp_side, _ = _float_map(0)
    kps1, lvl1, des1, val1, _ = kp_side
    pts = pt_side[0]
    T2 = np.asarray(jlie.se3_exp(jnp.asarray([0.5, 0.0, 0.1, 0.0, 0.02, 0.0]))).astype(np.float32)
    pc = pts @ T2[:3, :3].T + T2[:3, 3]
    uv2 = (pc[:, :2] / pc[:, 2:] * K[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]).astype(np.float32)
    kps2 = np.concatenate([uv2, r.uniform([0, 0], [320, 240], (100, 2))]).astype(np.float32)
    noisy = pt_side[1] + 0.05 * _unit(r, len(pts))
    des2 = np.concatenate([noisy / np.linalg.norm(noisy, axis=1, keepdims=True),
                           _unit(r, 100)]).astype(np.float32)
    lvl2 = r.integers(0, 4, len(kps2))
    free1 = val1 & (r.uniform(size=len(kps1)) > 0.2)
    free2 = r.uniform(size=len(kps2)) > 0.1
    F = fundamental_np(T2, K, K).astype(np.float32)
    epi = np.array([1e6, 1e6], np.float32)
    with jax.enable_x64(False):
        ref, _ = jsm.epipolar_triangulation_match(
            *_j([kps1, lvl1, des1, free1, kps2, lvl2, des2, free2]), jnp.asarray(F),
            jnp.asarray(epi), jnp.asarray(SIG2), 0.9)
    got = tsm.epipolar_triangulation_match(
        *_t([kps1, lvl1, des1, free1]), *[x[None] for x in _t([kps2, lvl2, des2, free2])],
        t(F)[None], t(epi)[None], t(SIG2), 0.9)
    assert np.array_equal(np_(got[0]), np.asarray(ref))
    assert (np.asarray(ref) >= 0).sum() > 10


# ------------------------------------------------------ ROOT_SIFT map
def _cam(cls, ds):
    return cls(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * ds.baseline,
               depth_threshold=20.0)


@pytest.fixture(scope="module")
def session():
    from pyslam_tpu.config_parameters import Parameters as JaxParameters
    from pyslam_tpu_torch.config_parameters import Parameters

    saved = [(P, {k: getattr(P, k) for k in ("kMaxDescriptorDistance",
                                              "kMaxOrbDistanceSearchByReproj")})
             for P in (JaxParameters, Parameters)]
    ds = JaxSyntheticDataset(num_frames=N_FRAMES + 2, trajectory="line", step=0.4,
                             sensor_type=JaxSensorType.STEREO)
    with jax.enable_x64(False):
        js = JaxSlam(_cam(JaxCamera, ds), JaxPresets.ROOT_SIFT, sensor_type=JaxSensorType.STEREO)
        for i in range(N_FRAMES):
            js.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                     timestamp=ds.getTimestamp(i))
        js.finish()
    cam = _cam(PinholeCamera, ds)
    tracker = feature_tracker_factory("ROOT_SIFT", device="cpu")
    # the session's L2 gates, as Slam sets them in both packages
    Parameters.kMaxDescriptorDistance = JaxParameters.kMaxDescriptorDistance
    Parameters.kMaxOrbDistanceSearchByReproj = JaxParameters.kMaxOrbDistanceSearchByReproj
    pmap = map_from_tpu_json(map_to_json(js.map), cam, tracker)
    yield dict(ds=ds, js=js, cam=cam, tracker=tracker, pmap=pmap)
    for P, vals in saved:
        for k, v in vals.items():
            setattr(P, k, v)


def test_root_sift_map_carried(session):
    js, pmap = session["js"], session["pmap"]
    assert js.map.points.desc.dtype == np.float32
    assert pmap.points.desc.dtype == np.float32 and pmap.points.desc.shape[1] == 128
    ids = js.map.points.alive_ids()
    assert np.array_equal(pmap.points.desc[ids], js.map.points.desc[ids])
    assert pmap.num_keyframes() == js.map.num_keyframes() >= 6


def test_float_stereo_row_match(session):
    """A SIFT extractor has no fused stereo path: both images are extracted
    and row-matched with the matcher's L2 distance, as the reference's
    ``compute_stereo_matches``."""
    ds, js = session["ds"], session["js"]
    i = 3
    with jax.enable_x64(False):
        jf = JaxFrame(js.camera, ds.getImage(i), img_right=ds.getImageRight(i),
                      feature_tracker=js.feature_tracker, frame_id=200)
    pf = Frame(session["cam"], ds.getImage(i), img_right=ds.getImageRight(i),
               feature_tracker=session["tracker"], frame_id=200)
    assert np.array_equal(pf.kps, jf.kps) and np.array_equal(pf.des, np.asarray(jf.des))
    ok = jf.kps_ur >= 0
    assert np.array_equal(pf.kps_ur >= 0, ok) and ok.sum() > 50
    np.testing.assert_allclose(pf.kps_ur[ok], jf.kps_ur[ok], rtol=1e-5)
    np.testing.assert_allclose(pf.depths[ok], jf.depths[ok], rtol=1e-5)


def test_float_relocalize(session):
    ds, js, pmap = session["ds"], session["js"], session["pmap"]
    jdet = JaxDetector(JaxConfigs.DBOW3)
    jdb = JaxDB(jdet.vocabulary.num_words)
    det = LoopDetector(LoopDetectorConfigs.DBOW3, device="cpu")
    db = KeyFrameDatabase(det.vocabulary.num_words)
    jwords = {}
    with jax.enable_x64(False):
        for kid in js.map.keyframe_order:
            w, g = jdet.describe_frame(js.map.keyframes[kid])
            jdb.add(kid, w, g)
            jdet.vocabulary.add_document(w)
            jwords[kid] = np.asarray(w)
    for kid in pmap.keyframe_order:
        w, g = det.describe_frame(pmap.keyframes[kid])
        db.add(kid, w, g)
        det.vocabulary.add_document(w)
        np.testing.assert_array_equal(w, jwords[kid])
    kf = js.map.keyframes[js.map.keyframe_order[-1]]
    i = min(kf.id + 1, N_FRAMES + 1)
    with jax.enable_x64(False):
        jf = JaxFrame(js.camera, ds.getImage(i), img_right=ds.getImageRight(i),
                      feature_tracker=js.feature_tracker, frame_id=100 + i)
    pf = Frame(session["cam"], feature_tracker=session["tracker"], frame_id=100 + i)
    pf.set_host_fields(kps=jf.kps.copy(), levels=jf.levels.copy(), angles=jf.angles.copy(),
                       sizes=jf.sizes.copy(), valid=jf.valid.copy(), kps_ur=jf.kps_ur.copy(),
                       depths=jf.depths.copy())
    pf.des = np.asarray(jf.des)
    push = np.asarray(jlie.se3_exp(jnp.asarray(
        np.array([0.3, 0.1, 0.4, 0.0, 0.05, 0.0], np.float32))), np.float64)
    T0 = push @ np.linalg.inv(ds.poses[i])
    jf.update_pose(T0)
    pf.update_pose(T0)
    with jax.enable_x64(False):
        T_r, ok_r = JaxRelocalizer(js.camera, jdb, jdet).relocalize(jf, js.map)
    rel = Relocalizer(session["cam"], db, det, device="cpu", sampler=JaxKeySampler(7))
    T, ok = rel.relocalize(pf, pmap)
    assert ok == ok_r and ok
    np.testing.assert_allclose(T, np.asarray(T_r), atol=RELOC_TOL)
    # the pose is held to the reference's above; its distance from the truth
    # is this short map's own
    np.testing.assert_allclose(np.linalg.inv(T)[:3, 3], ds.poses[i][:3, 3], atol=0.5)
    assert abs(int((pf.points >= 0).sum()) - int((jf.points >= 0).sum())) <= MARGIN


def test_float_geometry_check(session):
    js, pmap = session["js"], session["pmap"]
    with jax.enable_x64(False):
        jlc = JaxLoopClosing(js.map, js.camera, js.feature_tracker, "DBOW3",
                             sensor_type=JaxSensorType.STEREO)
        for kid in js.map.keyframe_order:
            w, g = jlc.detector.describe_frame(js.map.keyframes[kid])
            jlc.db.add(kid, w, g)
    plc = LoopClosing(pmap, session["cam"], session["tracker"], "DBOW3",
                      sensor_type=SensorType.STEREO, device="cpu", sampler=JaxKeySampler(11))
    for kid in pmap.keyframe_order:
        w, g = plc.detector.describe_frame(pmap.keyframes[kid])
        plc.db.add(kid, w, g)
    order = js.map.keyframe_order
    kid, cid = order[-1], order[-4]
    with jax.enable_x64(False):
        ok_r, S_r, n_r = jlc.geometry_check(jlc.map.keyframes[kid], jlc.map.keyframes[cid])
    ok, S, n = plc.geometry_check(pmap.keyframes[kid], pmap.keyframes[cid])
    assert ok == ok_r and ok, "a keyframe three back shares most of its points"
    np.testing.assert_allclose(S, S_r, atol=S_TOL)
    assert abs(n - n_r) <= MARGIN
