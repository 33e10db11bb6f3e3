"""The port's bag-of-words vocabularies and keyframe database against the
JAX package's.  Training is host numpy copied from the reference, so trees
and codebooks trained from the same ORB2 descriptors with the same seed are
identical; quantisation runs on the port's device and must give identical
words (integer distances, first index on ties).  Histograms are float32 and
held to 1e-6; database candidates are identical."""

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import synth_image

from pyslam_tpu.features.orb2 import ORB2Extractor as JaxORB2
from pyslam_tpu.loop_closing import vocabulary as jvoc
from pyslam_tpu.loop_closing.keyframe_database import KeyFrameDatabase as JaxDB
from pyslam_tpu_torch.loop_closing import vocabulary as pvoc
from pyslam_tpu_torch.loop_closing.keyframe_database import KeyFrameDatabase
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)


@pytest.fixture(scope="module")
def descriptors():
    """ORB2 descriptors (0/1 bit-planes) and valid masks of three images."""
    ext = JaxORB2(num_features=600, num_levels=4)
    out = []
    with jax.enable_x64(False):
        for seed in (0, 1, 2):
            f = ext(synth_image(np.random.default_rng(seed)))
            out.append((np.asarray(f.desc), np.asarray(f.valid)))
    return out


@pytest.fixture(scope="module")
def trees(descriptors):
    train = np.concatenate([d[v] for d, v in descriptors[:2]])
    ref = jvoc.HierarchicalVocabulary(branching=8, depth=4)
    got = pvoc.HierarchicalVocabulary(branching=8, depth=4, device="cpu")
    with jax.enable_x64(False):
        ref.seed_from_descriptors(train)
    got.seed_from_descriptors(train)
    return ref, got


@pytest.mark.parametrize("field", ["centroids", "children", "node_word", "word_level_node"])
def test_tree_identical(trees, field):
    ref, got = trees
    np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    assert got.num_words == ref.num_words


def test_tree_words_and_direct_index(trees, descriptors):
    ref, got = trees
    for desc, valid in descriptors:
        valid = valid.copy()
        valid[::7] = False
        with jax.enable_x64(False):
            w_ref = ref.words_for(desc, valid)
        w = got.words_for(desc, valid)
        np.testing.assert_array_equal(w, w_ref)
        assert (w[~valid] == -1).all() and (w[valid] >= 0).all()
        for level in range(ref.depth):
            np.testing.assert_array_equal(got.level_nodes_for(w, level),
                                          ref.level_nodes_for(w_ref, level))


def test_lazy_seeding_from_first_frame(descriptors):
    """words_for seeds an untrained tree from the valid descriptors it is
    given, as the detector does at the first keyframe."""
    desc, valid = descriptors[0]
    ref = jvoc.HierarchicalVocabulary(branching=8, depth=4)
    got = pvoc.HierarchicalVocabulary(branching=8, depth=4, device="cpu")
    with jax.enable_x64(False):
        w_ref = ref.words_for(desc, valid)
    np.testing.assert_array_equal(got.words_for(desc, valid), w_ref)
    np.testing.assert_array_equal(got.centroids, ref.centroids)


def test_flat_codebook_kmeans(descriptors):
    """The flat codebook of the SESSION_TRAINED presets: seeding and binary
    k-means (device argmin and majority vote) give identical codewords."""
    train = np.concatenate([d[v] for d, v in descriptors])
    ref = jvoc.BinaryVocabulary(num_words=512)
    got = pvoc.BinaryVocabulary(num_words=512, device="cpu")
    with jax.enable_x64(False):
        ref.seed_from_descriptors(train)
        ref.train_kmeans(train, iters=2)
    got.seed_from_descriptors(train)
    got.train_kmeans(train, iters=2)
    np.testing.assert_array_equal(got.words_bits, ref.words_bits)
    desc, valid = descriptors[2]
    with jax.enable_x64(False):
        w_ref = ref.words_for(desc, valid)
    np.testing.assert_array_equal(got.words_for(desc, valid), w_ref)


def test_histogram_and_idf(trees, descriptors):
    ref, got = trees
    for desc, valid in descriptors:
        with jax.enable_x64(False):
            w = ref.words_for(desc, valid)
            ref.add_document(w)
            g_ref = ref.global_descriptor(w)
        got.add_document(w)
        np.testing.assert_allclose(got.global_descriptor(w), g_ref, atol=1e-6)
    np.testing.assert_array_equal(got.idf_weights(), ref.idf_weights())
    idf = ref.idf_weights()
    with jax.enable_x64(False):
        h_ref = np.asarray(jvoc.bow_histogram(jax.numpy.asarray(w), jax.numpy.asarray(idf),
                                              ref.num_words))
    h = pvoc.bow_histogram(torch.as_tensor(w.astype(np.int64)), torch.as_tensor(idf),
                           got.num_words).numpy()
    np.testing.assert_allclose(h, h_ref, atol=1e-6)


def _fill(db_cls, words_by_kid, num_words, idf=None):
    db = db_cls(num_words)
    for kid, words in words_by_kid.items():
        h = np.zeros(num_words, np.float32)
        np.add.at(h, words[words >= 0], 1.0)
        db.add(kid, words, h / max(np.linalg.norm(h), 1e-12))
    db.idf = idf
    return db


def test_database_candidates_on_shared_words():
    """The fixture of tests/test_loop_closing.py: keyframes 0 and 5 share
    most words."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, 80)
    words = {kid: base.copy() if kid in (0, 5) else rng.integers(0, 256, 80)
             for kid in range(6)}
    dbs = [_fill(cls, words, 256) for cls in (JaxDB, KeyFrameDatabase)]
    out = [(db.detect_loop_candidates(5, base, db.kf_gdes[5], connected={4},
                                      covisibles_of=lambda k: []),
            db.detect_relocalization_candidates(base, db.kf_gdes[5])) for db in dbs]
    assert out[1] == out[0]
    assert 0 in out[1][0]


@pytest.mark.parametrize("use_idf", [False, True])
def test_database_candidates_on_places(trees, use_idf):
    """The place grid of tests/test_hierarchical_vocab.py: 12 places and
    their bit-noised revisits quantised by both trees, with covisibility
    groups of neighbouring places; loop and relocalisation candidates of
    every revisit identical."""
    ref, got = trees
    rng = np.random.default_rng(3)
    places = [rng.integers(0, 2, (200, 256)).astype(np.int8) for _ in range(12)]
    revisits = [(p ^ (rng.random(p.shape) < 0.05)).astype(np.int8) for p in places]
    ones = np.ones(200, bool)
    with jax.enable_x64(False):
        words = {kid: ref.words_for(p, ones) for kid, p in enumerate(places)}
        queries = [ref.words_for(r, ones) for r in revisits]
    for kid, p in enumerate(places):
        np.testing.assert_array_equal(got.words_for(p, ones), words[kid])
    idf = None
    if use_idf:
        counts = np.zeros(ref.num_words)
        for w in words.values():
            counts[np.unique(w)] += 1
        idf = (np.log((1.0 + len(words)) / (1.0 + counts)) + 1e-3).astype(np.float32)
    dbs = [_fill(cls, words, ref.num_words, idf) for cls in (JaxDB, KeyFrameDatabase)]

    def covis(k):
        return [j for j in (k - 1, k + 1) if 0 <= j < 12]

    for i, q in enumerate(queries):
        h = np.zeros(ref.num_words, np.float32)
        np.add.at(h, q, 1.0)
        h /= np.linalg.norm(h)
        res = [(db.detect_loop_candidates(100 + i, q, h, {(i + 6) % 12}, covis),
                db.detect_relocalization_candidates(q, h)) for db in dbs]
        assert res[1] == res[0]
        assert res[1][1][0] == i
