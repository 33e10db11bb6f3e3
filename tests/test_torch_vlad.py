"""VLAD, SAD, the score-based database path and the pretrained vocabulary
in the port (pyslam_tpu_torch/loop_closing/{vlad,vocabulary,loop_closing}.py)
against the JAX package, on ORB-layout descriptors (0/1 bit-planes, 256
columns) drawn from a seed, the JAX package run with x64 off.

Held: the trained VLAD centres are each package's k-means from the same
``default_rng`` draws, and the two packages' Lloyd rounds agree round by
round: fed the JAX package's centres, each round's assignments are
identical except where the two smallest of ``|c|^2 - 2 d.c`` are within
1e-4 of their largest magnitude (a float32 near-tie the two products
round either way, which a host's reduction order decides), and each new
centre within 1e-5 of the largest (a centre whose members a near-tie
moved: each package's within 1e-5 of the float64 mean of its own
members).  The end states are not compared bit for bit: one near-tie in
an early round sends the later rounds apart on some hosts.  The
nearest-centre assignments of trained centres identical except at those
near-ties; the VLAD and SAD descriptors within 1e-5 of their largest magnitude;
the score-based database's loop and relocalisation candidates identical
given each package's descriptors; ``from_dbow3_text`` on a vocabulary text
written under ``tmp_path`` the same tree as the JAX package's, with the
same words; a ``PRETRAINED`` detector loading a vocabulary the JAX package
saved gives the same words and histogram; ``VladVocabulary.to_json`` /
``from_json`` read either package's output back to that package's
centres, bit for bit.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.loop_closing import vlad as jvlad
from pyslam_tpu_torch.loop_closing import vlad
from tests.torch_parity import rel_err, rng

TOL = 1e-5
NEAR_TIE = 1e-4


def _desc(r, n=300, flip=0, base=None):
    d = r.integers(0, 2, (n, 256)).astype(np.int8) if base is None else base.copy()
    if flip:
        d[r.uniform(size=d.shape) < flip] ^= 1
    return d


def _trained(k=32, train_after=3, seed=0):
    """Both packages' vocabularies trained on the same three keyframes."""
    r = rng(seed)
    frames = [_desc(r, 500) for _ in range(train_after)]
    ref = jvlad.VladVocabulary(num_clusters=k, train_after=train_after)
    got = vlad.VladVocabulary(num_clusters=k, train_after=train_after, device="cpu")
    with jax.enable_x64(False):
        for f in frames:
            ref.maybe_train(f.astype(np.float32))
    for f in frames:
        got.maybe_train(f.astype(np.float32))
    return ref, got, np.concatenate(frames).astype(np.float32)


def _shared_init(data, k, seed=5):
    """The k-means seed both packages draw: ``default_rng(seed)``, one
    uniform, then ``choice`` of k rows."""
    r = np.random.default_rng(seed)
    r.uniform(0, 1, None)
    return data[r.choice(len(data), size=k, replace=False)]


def _members_close(centers, data, assign, k):
    """Each non-empty centre within TOL of the float64 mean of its members."""
    for c in range(k):
        m = assign == c
        if m.any():
            want = data[m].astype(np.float64).mean(0)
            assert np.abs(centers[c] - want).max() <= TOL * np.abs(want).max()


def _hold_lloyd_rounds(k, iters=8):
    """Train both packages, check each one's centres are its own k-means
    from the shared draw, then hold the two Lloyd steps round by round,
    both fed the JAX package's centres."""
    ref, got, data = _trained(k=k)
    assert ref.trained and got.trained and got.consume_just_trained()
    init = _shared_init(data, k)
    with jax.enable_x64(False):
        own_ref = np.asarray(jvlad._kmeans(jnp.asarray(data), jnp.asarray(init), k, iters))
    own_got = vlad._kmeans(torch.from_numpy(data), torch.from_numpy(init), iters).numpy()
    np.testing.assert_array_equal(np.asarray(ref.centers), own_ref)
    np.testing.assert_array_equal(got.centers, own_got)
    c_in, n_ties = init, 0
    for _ in range(iters):
        with jax.enable_x64(False):
            a_ref = np.asarray(jvlad._assign(jnp.asarray(data), jnp.asarray(c_in), k))
            new_ref = np.asarray(jvlad._kmeans(jnp.asarray(data), jnp.asarray(c_in), k, 1))
        a_got = vlad._assign(torch.from_numpy(data), torch.from_numpy(c_in)).numpy()
        new_got = vlad._kmeans(torch.from_numpy(data), torch.from_numpy(c_in), 1).numpy()
        differ = a_got != a_ref
        score = (c_in * c_in).sum(1)[None] - 2.0 * data.astype(np.float64) @ c_in.T
        two = np.sort(score, 1)[:, :2]
        assert np.all(two[differ, 1] - two[differ, 0] <= NEAR_TIE * np.abs(score).max())
        n_ties += int(differ.sum())
        moved = np.zeros(k, bool)
        moved[a_got[differ]] = moved[a_ref[differ]] = True
        scale = np.abs(new_ref).max()
        assert np.abs(new_got[~moved] - new_ref[~moved]).max(initial=0.0) <= TOL * scale
        _members_close(new_got, data, a_got, k)
        _members_close(new_ref, data, a_ref, k)
        c_in = np.array(new_ref)
    assert n_ties <= 0.01 * len(data) * iters


def test_vlad_centres_identical():
    """k = 32: each package's trained centres are its own k-means from the
    shared draw, and the Lloyd rounds agree round by round."""
    _hold_lloyd_rounds(32)


def test_kmeans_held_round_by_round():
    """k = 8, the vocabulary the JSON test round-trips."""
    _hold_lloyd_rounds(8)


def test_assignments_identical_but_near_ties():
    _, got, data = _trained()
    centers = got.centers
    r = rng(1)
    desc = np.concatenate([data[:500], r.normal(0.5, 0.3, (500, 256)).astype(np.float32)])
    with jax.enable_x64(False):
        want = np.asarray(jvlad._assign(jnp.asarray(desc), jnp.asarray(centers), len(centers)))
    a = vlad._assign(torch.from_numpy(desc), torch.from_numpy(centers)).numpy()
    differ = a != want
    score = (centers * centers).sum(1)[None] - 2.0 * desc.astype(np.float64) @ centers.T
    two = np.sort(score, 1)[:, :2]
    assert np.all(two[differ, 1] - two[differ, 0] <= NEAR_TIE * np.abs(score).max())
    assert differ.mean() <= 0.01


def test_vlad_and_sad_descriptors():
    ref, got, _ = _trained()
    r = rng(2)
    base = _desc(r)
    valid = np.ones(len(base), bool)
    valid[::7] = False
    for d in (base, _desc(r, flip=0.02, base=base), _desc(r)):
        with jax.enable_x64(False):
            want = ref.global_descriptor(d, valid)
        g = got.global_descriptor(torch.from_numpy(d), torch.from_numpy(valid))
        assert g.shape == (32 * 256,) and rel_err(g, want) <= TOL
        assert rel_err(got.global_descriptor(d, valid), want) <= TOL     # host input
    img = rng(3).uniform(0, 255, (75, 130)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jvlad.sad_descriptor(jnp.asarray(img)))
    assert rel_err(vlad.sad_descriptor(torch.from_numpy(img)).numpy(), want) <= TOL


def test_placeholder_before_training():
    """Untrained: the normalised mean descriptor in centre 0's slot, and the
    keyframes' descriptors buffered for training."""
    ref = jvlad.VladVocabulary(num_clusters=16, train_after=2)
    got = vlad.VladVocabulary(num_clusters=16, train_after=2, device="cpu")
    d = _desc(rng(4))
    valid = np.ones(len(d), bool)
    with jax.enable_x64(False):
        want = ref.global_descriptor(d, valid)
    g = got.global_descriptor(d, valid)
    assert not got.trained and rel_err(g, want) <= TOL
    assert np.count_nonzero(g[256:]) == 0
    got.global_descriptor(d, valid)
    assert got.trained and got.consume_just_trained()


def test_score_based_candidates_identical():
    from pyslam_tpu.loop_closing.keyframe_database import KeyFrameDatabase as JDB
    from pyslam_tpu_torch.loop_closing.keyframe_database import KeyFrameDatabase

    ref, got, _ = _trained()
    r = rng(5)
    places = [_desc(r) for _ in range(8)]
    valid = np.ones(300, bool)
    jdb, db = JDB(num_words=0), KeyFrameDatabase(num_words=0)
    for kid, d in enumerate(places):
        with jax.enable_x64(False):
            jdb.add(kid, None, ref.global_descriptor(d, valid))
        db.add(kid, None, got.global_descriptor(d, valid))
    q = _desc(r, flip=0.03, base=places[3])
    with jax.enable_x64(False):
        jq = ref.global_descriptor(q, valid)
    pq = got.global_descriptor(q, valid)
    want = jdb.detect_loop_candidates(kid=100, words=None, g_des=jq, connected={2, 4},
                                      covisibles_of=lambda k: [])
    out = db.detect_loop_candidates(kid=100, words=None, g_des=pq, connected={2, 4},
                                    covisibles_of=lambda k: [])
    assert 3 in want and out == want
    assert (db.detect_relocalization_candidates(None, pq, max_out=3)
            == jdb.detect_relocalization_candidates(None, jq, max_out=3))


def test_vlad_json_either_package():
    ref, got, _ = _trained(k=8)
    for src in (ref, got):
        d = json.loads(json.dumps(src.to_json()))
        p = vlad.VladVocabulary.from_json(d, device="cpu")
        j = jvlad.VladVocabulary.from_json(d)
        assert p.trained and j.trained
        np.testing.assert_array_equal(p.centers, np.asarray(src.centers))
        np.testing.assert_array_equal(np.asarray(j.centers), np.asarray(src.centers))
    assert vlad.VladVocabulary.from_json({"k": 4, "centers": None}, device="cpu").trained is False


def _dbow3_text(path, seed=4, k=3, L=2, B=32):
    """A small DBoW3 text vocabulary: k children a node, L levels, leaves
    perturbations of their parent, weights per leaf."""
    r = rng(seed)
    lines = [f"{k} {L} 0 0"]
    parents = [(0, None)]
    nid = 0
    for level in range(L):
        nxt = []
        for pid, pc in parents:
            for _ in range(k):
                c = r.integers(0, 256, B).astype(np.uint8) if pc is None else pc.copy()
                if pc is not None:
                    c[r.choice(B, 3, replace=False)] ^= np.uint8(0x0F)
                leaf = level == L - 1
                w = float(np.round(r.uniform(0.1, 2.0), 4)) if leaf else 0.0
                lines.append(f"{pid} {int(leaf)} {' '.join(map(str, c))} {w}")
                nid += 1
                nxt.append((nid, c))
        parents = nxt
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_from_dbow3_text(tmp_path):
    from pyslam_tpu.loop_closing.vocabulary import HierarchicalVocabulary as JVoc
    from pyslam_tpu_torch.loop_closing.vocabulary import HierarchicalVocabulary

    fp = _dbow3_text(tmp_path / "voc.txt")
    ref = JVoc.from_dbow3_text(fp)
    got = HierarchicalVocabulary.from_dbow3_text(fp, device="cpu")
    assert got.k == 3 and got.depth == 2 and got.num_words == 9
    for name in ("centroids", "children", "node_word", "word_weights", "word_level_node"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert got.checksum() == ref.checksum()
    desc = rng(6).integers(0, 2, (400, 256)).astype(np.int8)
    valid = np.ones(400, bool)
    with jax.enable_x64(False):
        want = ref.words_for(desc, valid)
    np.testing.assert_array_equal(got.words_for(desc, valid), want)


def test_pretrained_detector(tmp_path):
    """``PRETRAINED``: the detector loads ``extra["vocabulary_path"]`` (a
    vocabulary the JAX package imported from DBoW3 text and saved) and
    describes a frame by the same words and histogram."""
    from pyslam_tpu.loop_closing.loop_closing import LoopDetector as JDetector
    from pyslam_tpu.loop_closing.loop_detector_configs import LoopDetectorConfigs as JConfigs
    from pyslam_tpu.loop_closing.loop_detector_configs import (
        LoopDetectorVocabularyType as JVT,
    )
    from pyslam_tpu.loop_closing.vocabulary import HierarchicalVocabulary as JVoc
    from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
    from pyslam_tpu_torch.loop_closing.loop_detector_configs import (
        LoopDetectorConfigs,
        LoopDetectorVocabularyType,
    )

    path = str(tmp_path / "voc.npz")
    JVoc.from_dbow3_text(_dbow3_text(tmp_path / "voc.txt")).save(path)
    extra = {"vocabulary_path": path}
    ref = JDetector(dataclasses.replace(JConfigs.DBOW3, vocabulary_type=JVT.PRETRAINED,
                                        extra=extra))
    got = LoopDetector(dataclasses.replace(
        LoopDetectorConfigs.DBOW3, vocabulary_type=LoopDetectorVocabularyType.PRETRAINED,
        extra=extra), device="cpu")
    assert not got.score_based and got.vocabulary.word_weights is not None
    des = rng(7).integers(0, 2, (300, 256)).astype(np.int8)
    valid = np.ones(300, bool)
    valid[::5] = False
    tdes, tvalid = torch.from_numpy(des), torch.from_numpy(valid)
    frame = SimpleNamespace(des=des, valid=valid, img_thumb=None, img_vpr=None,
                            dev=lambda name: {"des": tdes, "valid": tvalid}[name])
    with jax.enable_x64(False):
        rw, rg = ref.describe_frame(frame)
    w, g = got.describe_frame(frame)
    np.testing.assert_array_equal(w, rw)
    assert rel_err(g, rg) <= TOL


@pytest.mark.parametrize("preset", ["VLAD", "SAD"])
def test_detector_is_score_based(preset):
    from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
    from pyslam_tpu_torch.loop_closing.loop_detector_configs import LoopDetectorConfigs

    det = LoopDetector(LoopDetectorConfigs.get(preset), device="cpu")
    assert det.score_based and det.netvlad is None
    assert (det.vlad is not None) == (preset == "VLAD")
