"""Relocalisation of the port against the JAX package: RANSAC PnP with the
reference's minimal samples injected, the direct-index guided mask, and the
relocalisation of a frame of the stream whose pose is lost.

The map: the JAX ``Slam`` (x64 off) tracks 12 frames of the 240x320 stereo
line stream and is carried across with ``interop.map_from_tpu_json``; both
packages' detectors register its keyframes.  The lost frame is the frame
after a keyframe, its features extracted by the JAX package and handed to
the port, its pose pushed 0.5 m and 3 degrees away.

Tolerances: the PnP pose within 1e-3 (float32 DLT eigenvectors and
Gauss-Newton in two frameworks); the relocalised pose within 5e-3 (it adds
40 float32 LM iterations of the pose optimisation on ~300 points; measured
1.8e-3 at most); inlier sets within 2 of N (a point flips only at float32
rounding of its gate, see test_torch_sim3.py); the guided mask and the ok
flag identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_parity import JaxKeySampler, np_, t

from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.loop_closing.keyframe_database import KeyFrameDatabase as JaxDB
from pyslam_tpu.loop_closing.loop_closing import LoopDetector as JaxDetector
from pyslam_tpu.loop_closing.loop_detector_configs import LoopDetectorConfigs as JaxConfigs
from pyslam_tpu.loop_closing.relocalizer import Relocalizer as JaxRelocalizer
from pyslam_tpu.ops import epipolar as jepi
from pyslam_tpu.ops import lie as jlie
from pyslam_tpu.ops import pnp as jpnp
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.frame import Frame as JaxFrame
from pyslam_tpu.slam.map_serialization import map_to_json
from pyslam_tpu.slam.slam import Slam as JaxSlam
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
from pyslam_tpu_torch.interop import map_from_tpu_json
from pyslam_tpu_torch.loop_closing.keyframe_database import KeyFrameDatabase
from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
from pyslam_tpu_torch.loop_closing.loop_detector_configs import LoopDetectorConfigs
from pyslam_tpu_torch.loop_closing.relocalizer import Relocalizer
from pyslam_tpu_torch.loop_closing.vocabulary import HierarchicalVocabulary
from pyslam_tpu_torch.ops import pnp
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.frame import Frame
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

POSE_TOL = 1e-3
RELOC_TOL = 5e-3
MARGIN = 2
N_FRAMES = 12


def _pnp_scene(rng, n=100, n_out=25):
    """100 correspondences at 4-12 m with 0.1 px of noise, 25 outliers (the
    6-point DLT of both packages breaks down at 0.5 px on 25 m depths)."""
    pts = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    Tcw = np.asarray(jlie.se3_exp(jnp.asarray(
        np.array([0.4, -0.1, 0.8, 0.05, -0.2, 0.03], np.float32))), np.float64)
    pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
    xy = pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.1 / 200.0, (n, 2))
    out = rng.choice(n, n_out, replace=False)
    xy[out] = rng.uniform(-0.8, 0.8, (n_out, 2))
    m = 128
    valid = np.arange(m) < n
    pad = lambda a: np.concatenate([a, np.zeros((m - n, a.shape[1]))]).astype(np.float32)  # noqa
    return pad(pts), pad(xy), valid, Tcw


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_pnp_ransac_injected_samples(seed):
    pts, xy, valid, Tcw = _pnp_scene(np.random.default_rng(seed))
    key = jax.random.PRNGKey(7 + seed)
    th2 = 5.99 / 200.0 ** 2
    with jax.enable_x64(False):
        samples = np.asarray(jepi._sample_minimal(key, jnp.asarray(valid), 64, 6))
        T_r, m_r, n_r = jpnp.solve_pnp_ransac(key, jnp.asarray(pts), jnp.asarray(xy),
                                              jnp.asarray(valid), th2, 64)
    T, m, n = pnp.solve_pnp_ransac(t(pts), t(xy), t(valid), th2, 64, samples=t(samples))
    np.testing.assert_allclose(np_(T), np.asarray(T_r), atol=POSE_TOL)
    np.testing.assert_allclose(np_(T), Tcw, atol=0.05)
    assert abs(int(n) - int(n_r)) <= MARGIN and int(n) >= 70
    assert int((np_(m) != np.asarray(m_r)).sum()) <= MARGIN


def test_guided_mask_identical():
    """As tests/test_hierarchical_vocab.py::test_guided_mask_in_relocalizer,
    on both packages: the mask admits exactly the pairs sharing a subtree."""
    rng = np.random.default_rng(7)
    desc = rng.integers(0, 2, (100, 256)).astype(np.int8)
    voc = HierarchicalVocabulary(branching=4, depth=3, seed=8, device="cpu")
    words = voc.words_for(desc, np.ones(len(desc), bool))
    masks = []
    for R, DB in ((JaxRelocalizer, JaxDB), (Relocalizer, KeyFrameDatabase)):
        db = DB(voc.num_words)
        db.add(5, words, np.zeros(voc.num_words, np.float32))
        det = type("D", (), {"vocabulary": voc})()
        kw = {"device": "cpu"} if R is Relocalizer else {}
        r = R(camera=None, keyframe_db=db, detector=det, **kw)
        r._frame_words = words
        masks.append(r._guided_mask(5, np.arange(100)))
    np.testing.assert_array_equal(masks[1], masks[0])
    nodes = voc.level_nodes_for(words, max(0, voc.depth - 3))
    np.testing.assert_array_equal(masks[1], (nodes[:, None] == nodes[None, :]))


@pytest.fixture(scope="module")
def session():
    ds = JaxSyntheticDataset(num_frames=N_FRAMES + 2, trajectory="line", step=0.4,
                             sensor_type=JaxSensorType.STEREO)
    cam_args = (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    kw = dict(fps=ds.fps, bf=ds.fx * ds.baseline, depth_threshold=20.0)
    with jax.enable_x64(False):
        js = JaxSlam(JaxCamera(*cam_args, **kw), JaxTrackerConfig(num_features=600, num_levels=4),
                     sensor_type=JaxSensorType.STEREO)
        for i in range(N_FRAMES):
            js.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                     timestamp=ds.getTimestamp(i))
        js.finish()
        jdet = JaxDetector(JaxConfigs.DBOW3)
        jdb = JaxDB(jdet.vocabulary.num_words)
        for kid in js.map.keyframe_order:
            w, g = jdet.describe_frame(js.map.keyframes[kid])
            jdb.add(kid, w, g)
            jdet.vocabulary.add_document(w)
    cam = PinholeCamera(*cam_args, **kw)
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=600, num_levels=4),
                                      device="cpu")
    pmap = map_from_tpu_json(map_to_json(js.map), cam, tracker)
    det = LoopDetector(LoopDetectorConfigs.DBOW3, device="cpu")
    db = KeyFrameDatabase(det.vocabulary.num_words)
    for kid in pmap.keyframe_order:
        w, g = det.describe_frame(pmap.keyframes[kid])
        db.add(kid, w, g)
        det.vocabulary.add_document(w)
    return dict(ds=ds, js=js, jrel=JaxRelocalizer(js.camera, jdb, jdet), pmap=pmap, cam=cam,
                tracker=tracker, rel=Relocalizer(cam, db, det, device="cpu",
                                                 sampler=JaxKeySampler(7)))


@pytest.mark.parametrize("which", [1, -1])
def test_relocalize_lost_frame(session, which):
    """The frame after keyframe ``which`` (its features extracted once, by
    the JAX package), pose pushed away: both packages relocalise it, to the
    same pose, from the same candidates and minimal samples."""
    ds, js = session["ds"], session["js"]
    kf = js.map.keyframes[js.map.keyframe_order[which]]
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
        T_r, ok_r = session["jrel"].relocalize(jf, js.map)
    T, ok = session["rel"].relocalize(pf, session["pmap"])
    assert ok == ok_r and ok
    np.testing.assert_allclose(T, np.asarray(T_r), atol=RELOC_TOL)
    # near the truth (the map itself has drifted a few centimetres)
    np.testing.assert_allclose(np.linalg.inv(T)[:3, 3], ds.poses[i][:3, 3], atol=0.15)
    assert abs(int((pf.points >= 0).sum()) - int((jf.points >= 0).sum())) <= MARGIN
    assert int((pf.points != jf.points).sum()) <= MARGIN
