"""Semantic fusion in the port (pyslam_tpu_torch/semantics/{semantic_mapping,
semantic_eval}.py, pyslam_tpu_torch/dense/semantic_volume.py, the map's
point-removal listeners) against the JAX package, on keyframes, points,
images and depths drawn from a seed; the JAX package run with x64 off.

Held: given the same keyframes, points and segmenter, ``kps_sem``
identical, ``point_scores`` within 1e-6 (the same float32 additions in the
same order), ``point_label``, ``point_confidence`` and
``get_semantic_weight`` identical; a deleted point's accumulators pruned
and a replaced one's merged, as the reference's listener does; the
FEATURE_VECTOR mode's fused embeddings within 1e-5 (CLIP's embeddings
agree to that, the JAX package's weights carried across) and
``query_points_by_text`` the same pids in the same order; the confusion
matrix identical and mIoU, pixel accuracy and fwIoU equal; the semantic
TSDF volume's slots, keys and occupancy identical, ``class_scores`` within
1e-5 of their largest magnitude for COUNTING and BAYESIAN fusion, and
``extract_semantic_point_cloud`` identical.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from pyslam_tpu.dense import semantic_volume as jvol
from pyslam_tpu.semantics import semantic_eval as jeval
from pyslam_tpu.semantics import semantic_mapping as jsm
from pyslam_tpu.semantics import semantic_segmentation as jseg
from pyslam_tpu.slam.map import Map as JMap
from pyslam_tpu_torch.dense import semantic_volume as vol
from pyslam_tpu_torch.semantics import semantic_eval, semantic_mapping as sm
from pyslam_tpu_torch.semantics import semantic_segmentation as seg
from pyslam_tpu_torch.slam.map import Map
from tests.torch_parity import rel_err, rng
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

SCORE_TOL = 1e-6
EMB_TOL = 1e-5
VOL_TOL = 1e-5
H, W = 60, 80


def _keyframes(seed, n_kf=4, n_kp=40, n_pts=30):
    """Keyframes as the mapper reads them: raw keypoints inside the image
    (some on the border), observed point ids (-1 for none; a point seen
    by several keyframes) and the keyframe's image."""
    r = rng(seed)
    out = []
    for kid in range(n_kf):
        kps = np.stack([r.uniform(-1, W, n_kp), r.uniform(-1, H, n_kp)], 1).astype(np.float32)
        pts = r.choice(n_pts, n_kp, replace=False) if n_kp <= n_pts else \
            r.integers(0, n_pts, n_kp)
        pts = np.where(r.uniform(size=n_kp) < 0.25, -1, pts).astype(np.int64)
        img = r.uniform(0, 255, (H, W)).astype(np.float32)
        out.append((kid, kps, pts, img))
    return out


def _kf(kid, kps, pts):
    return SimpleNamespace(kid=kid, kps_raw=kps.copy(), points=pts.copy(),
                           kps=kps.copy())


def _pair(cfg_kw, jseg_obj=None, seg_obj=None):
    jmap, pmap = JMap(), Map(device="cpu")
    for m in (jmap, pmap):
        m.points.new_points(40)
        m.points.valid[:40] = True
    ref = jsm.SemanticMappingDense(jmap, jsm.SemanticMappingConfig(**cfg_kw), segmenter=jseg_obj)
    kw = dict(cfg_kw)
    if "feature_type" in kw:
        kw["feature_type"] = sm.SemanticFeatureType(kw["feature_type"].value)
    got = sm.SemanticMappingDense(pmap, sm.SemanticMappingConfig(**kw), segmenter=seg_obj,
                                  device="cpu")
    return ref, got


def _feed(ref, got, kfs, through_queue=True):
    jkfs, pkfs = [], []
    for kid, kps, pts, img in kfs:
        jk, pk = _kf(kid, kps, pts), _kf(kid, kps, pts)
        if through_queue:
            ref.offer_keyframe_image(kid, img)
            got.offer_keyframe_image(kid, img)
            ref.add_keyframe(jk)
            got.add_keyframe(pk)
        else:
            ref.add_keyframe(jk, img=img)
            got.add_keyframe(pk, img=img)
        jkfs.append(jk)
        pkfs.append(pk)
    with jax.enable_x64(False):
        assert ref.step()
        ref.run_all()
    assert got.step()
    got.run_all()
    assert not got.step() and not got.queue and not got._pending_imgs
    return jkfs, pkfs


def _assert_same_fusion(ref, got, jkfs, pkfs):
    for jk, pk in zip(jkfs, pkfs):
        np.testing.assert_array_equal(pk.kps_sem, jk.kps_sem)
    assert set(got.point_scores) == set(ref.point_scores)
    for pid, acc in ref.point_scores.items():
        assert np.abs(got.point_scores[pid] - acc).max() <= SCORE_TOL
        assert got.point_label(pid) == ref.point_label(pid)
        assert got.point_confidence(pid) == pytest.approx(ref.point_confidence(pid), abs=1e-6)
    assert got.point_label(999) == ref.point_label(999) == -1
    assert got.point_confidence(999) == ref.point_confidence(999) == 0.0


@pytest.mark.parametrize("feature", ["probability_vector", "label"])
def test_fusion_identical(feature):
    cfg = dict(num_classes=19, dataset="cityscapes",
               feature_type=jsm.SemanticFeatureType(feature))
    ref, got = _pair(cfg, jseg.IntensityBandSegmentation(19), seg.IntensityBandSegmentation(19))
    kfs = _keyframes(0)
    jkfs, pkfs = _feed(ref, got, kfs, through_queue=feature == "label")
    _assert_same_fusion(ref, got, jkfs, pkfs)
    labels = np.concatenate([k.kps_sem for k in pkfs] + [np.array([-1, 19, 8, 300])])
    np.testing.assert_array_equal(got.get_semantic_weight(labels),
                                  ref.get_semantic_weight(labels))
    assert got.get_semantic_weight(8) == np.float32(0.001)


def test_listener_prunes_and_merges():
    cfg = dict(num_classes=8)
    ref, got = _pair(cfg, jseg.IntensityBandSegmentation(8), seg.IntensityBandSegmentation(8))
    _feed(ref, got, _keyframes(1))
    pids = sorted(got.point_scores)
    dead, old, new = pids[0], pids[1], pids[2]
    before = got.point_scores[old] + got.point_scores[new]
    for s in (ref, got):
        s.map.delete_point(dead)
        s.map.replace_point(old, new)
    assert dead not in got.point_scores and old not in got.point_scores
    np.testing.assert_array_equal(got.point_scores[new], before)
    assert set(got.point_scores) == set(ref.point_scores)
    for pid, acc in ref.point_scores.items():
        assert np.abs(got.point_scores[pid] - acc).max() <= SCORE_TOL


def test_reset_moves_the_listener():
    """``reset(new_map)`` (what ``Slam.reset()`` calls) empties the
    accumulators and listens to the new map only."""
    _, got = _pair({}, None, seg.IntensityBandSegmentation(8))
    _feed_port_only(got)
    old_map, new_map = got.map, Map(device="cpu")
    got.reset(new_map)
    assert not got.point_scores and got.map is new_map
    assert got._on_point_removed not in old_map.point_removal_listeners
    assert new_map.point_removal_listeners == [got._on_point_removed]


def _feed_port_only(got):
    for kid, kps, pts, img in _keyframes(2, n_kf=1):
        got.add_keyframe(_kf(kid, kps, pts), img=img)
    got.run_all()
    assert got.point_scores


def test_feature_vector_and_text_query():
    from pyslam_tpu.models import clip as jclip
    from pyslam_tpu_torch import interop
    from pyslam_tpu_torch.models import clip
    from tests.test_torch_semantic_models import CLIP_SMALL
    from tests.torch_parity import compiled_flax_init, flat_variables

    with jax.enable_x64(False), compiled_flax_init():
        jback = jseg.CLIPOpenVocabSegmentation(cfg=jclip.CLIPConfig(**CLIP_SMALL))
    back = seg.CLIPOpenVocabSegmentation(cfg=clip.CLIPConfig(**CLIP_SMALL), device="cpu")
    back.model.image.load_state_dict(interop.clip_state_dict(
        flat_variables(jback.model.image_params)))
    back.model.text.load_state_dict(interop.clip_state_dict(
        flat_variables(jback.model.text_params)))
    back.set_labels(back.labels)
    cfg = dict(num_classes=8, feature_type=jsm.SemanticFeatureType.FEATURE_VECTOR)
    ref, got = _pair(cfg, jback, back)
    kfs = [(kid, kps, pts, np.stack([img] * 3, -1)) for kid, kps, pts, img in _keyframes(3)]
    jkfs, pkfs = _feed(ref, got, kfs)
    for jk, pk in zip(jkfs, pkfs):
        # labels may part only where two prompts' similarities nearly tie
        assert (pk.kps_sem == jk.kps_sem).mean() >= 0.95
    assert set(got.point_embeddings) == set(ref.point_embeddings)
    for pid in ref.point_embeddings:
        assert got.point_embedding_counts[pid] == ref.point_embedding_counts[pid]
        assert rel_err(got.point_embedding(pid), ref.point_embedding(pid)) <= EMB_TOL
    with jax.enable_x64(False):
        want_p, want_s = ref.query_points_by_text("chair", top_k=10)
    p, s = got.query_points_by_text("chair", top_k=10)
    np.testing.assert_array_equal(p, want_p)
    assert np.abs(s - want_s).max() <= EMB_TOL


def test_semantic_eval_identical():
    r = rng(4)
    gt = r.integers(-1, 6, (40, 50))
    pred = np.where(r.uniform(size=gt.shape) < 0.7, gt, r.integers(0, 7, gt.shape))
    for nc, ign in ((6, -1), (6, 2), (4, -1)):
        np.testing.assert_array_equal(semantic_eval.confusion_matrix(pred, gt, nc, ign),
                                      jeval.confusion_matrix(pred, gt, nc, ign))
        a = semantic_eval.evaluate_labels(pred, gt, nc, ign)
        b = jeval.evaluate_labels(pred, gt, nc, ign)
        assert (a.miou, a.pixel_accuracy, a.fw_iou, a.num_evaluated) == \
            (b.miou, b.pixel_accuracy, b.fw_iou, b.num_evaluated)
        np.testing.assert_array_equal(a.per_class_iou, b.per_class_iou)
    ref, got = _pair({}, jseg.IntensityBandSegmentation(8), seg.IntensityBandSegmentation(8))
    _feed(ref, got, _keyframes(5))
    truth = {pid: pid % 8 for pid in range(40)}
    a = semantic_eval.evaluate_map_points(got.map, got, truth.get, 8)
    b = jeval.evaluate_map_points(ref.map, ref, truth.get, 8)
    assert (a.miou, a.pixel_accuracy, a.num_evaluated) == (b.miou, b.pixel_accuracy,
                                                             b.num_evaluated)


def _scene(seed):
    r = rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (1.5 + 0.01 * xx + 0.005 * yy + r.normal(0, 0.01, (H, W))).astype(np.float32)
    depth[:5, :7] = 0.0                                   # holes
    img = r.uniform(0, 255, (H, W)).astype(np.float32)
    labels = r.integers(0, 8, (H, W)).astype(np.int32)
    labels[0, :10] = -1                                   # out of range: dropped
    probs = r.uniform(0.01, 1, (H, W, 8)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    K = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]])
    Twc = np.eye(4)
    Twc[:3, 3] = [0.1, -0.2, 0.05]
    c, s = np.cos(0.1), np.sin(0.1)
    Twc[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    return depth, img, labels, probs, K, Twc


@pytest.mark.parametrize("fusion", ["counting", "bayesian"])
def test_semantic_volume_identical(fusion):
    kw = dict(num_classes=8, voxel_size=0.05, sdf_trunc=0.2, depth_trunc=5.0, capacity=1 << 16)
    ref = jvol.SemanticTSDFVolume(fusion=jvol.SemanticFusionMethod(fusion), **kw)
    got = vol.SemanticTSDFVolume(fusion=vol.SemanticFusionMethod(fusion), device="cpu", **kw)
    for seed in (6, 7):                                    # two views into one volume
        depth, img, labels, probs, K, Twc = _scene(seed)
        with jax.enable_x64(False):
            ref.integrate_semantic(depth, img, labels, Twc, K, label_probs=probs)
        got.integrate_semantic(depth, img, labels, Twc, K, label_probs=probs)
    for name in ("keys", "occupied"):
        np.testing.assert_array_equal(got._np(name), np.asarray(getattr(ref.table, name)))
    want = np.asarray(ref.class_scores)
    assert np.abs(want).max() > 0 and rel_err(got.class_scores, want) <= VOL_TOL
    pts, labs = got.extract_semantic_point_cloud(tsdf_band=0.3, min_weight=0.5)
    jpts, jlabs = ref.extract_semantic_point_cloud(tsdf_band=0.3, min_weight=0.5)
    assert len(pts) > 100
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(labs, jlabs)
    got.reset()
    assert not got.class_scores.any() and got.num_voxels() == 0
