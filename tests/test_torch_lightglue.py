"""LightGlue in the port (pyslam_tpu_torch/models/lightglue.py) against the
JAX package's ``LightGlueMatcher``, with the bundled weights carried across
(``interop.lightglue_state_dict``), and the quality floors of
tests/test_trained_matcher_vpr.py on the port.  Inputs: the JAX package's
pair generator (``models.train_lightglue.make_pair``: 64 keypoints a side,
descriptors drawn from a shared pool of repeated texture).

Tolerances: log-assignment scores within 1e-4 absolute; match indices
identical.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models.lightglue import LightGlueMatcher as JaxLightGlue
from pyslam_tpu.models.train_lightglue import H, W, make_pair, nn_baseline
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.features import matcher as tmatcher
from pyslam_tpu_torch.features.types import NormType
from pyslam_tpu_torch.models.lightglue import LightGlueMatcher, LightGlueNet
from tests.torch_parity import np_, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64(False):
        ref = JaxLightGlue()
    return ref, LightGlueMatcher(device="cpu")


def _feats(d, xy, valid):
    return (SimpleNamespace(desc=jnp.asarray(d), xy=jnp.asarray(xy), valid=jnp.asarray(valid)),
            SimpleNamespace(desc=t(d), xy=t(xy), valid=t(valid)))


def _ref_scores(ref, j0, j1, image_wh=(W, H)):
    c = jnp.asarray(image_wh, jnp.float32) / 2.0
    s, _ = ref.net.apply(ref.params, j0.desc, (j0.xy - c) / jnp.max(c), j0.valid,
                         j1.desc, (j1.xy - c) / jnp.max(c), j1.valid)
    return np.asarray(s)


def test_bundled_weights_are_carried_across(pair):
    ref, got = pair
    assert ref.trained and got.trained
    assert (got.net.dim, got.net.layers, got.net.input_dim) == (96, 4, 256)
    sd = got.net.state_dict()
    p = ref.params["params"]
    assert np.array_equal(np_(sd["rotary_w"]), np.asarray(p["rotary_w"]))
    assert np.array_equal(np_(sd["layer_2.cross_attn.to_v.weight"]),
                          np.asarray(p["layer_2"]["cross_attn"]["to_v"]["kernel"]).T)
    assert np.array_equal(np_(sd["layer_3.self_ffn1_ln.weight"]),
                          np.asarray(p["layer_3"]["self_ffn1_ln"]["scale"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_scores_and_matches(pair, seed, masked):
    """Scores (64, 64) and mutual-best indices of one generated pair; with
    ``masked`` a fifth of the keypoints of each side are invalid (their
    rows and columns take -1e9, as in the reference)."""
    ref, got = pair
    r = np.random.default_rng(seed)
    d0, xy0, d1, xy1, _ = make_pair(r)
    v0 = r.uniform(size=len(d0)) > (0.2 if masked else -1.0)
    v1 = r.uniform(size=len(d1)) > (0.2 if masked else -1.0)
    j0, p0 = _feats(d0, xy0, v0)
    j1, p1 = _feats(d1, xy1, v1)
    with jax.enable_x64(False):
        ref_s = _ref_scores(ref, j0, j1)
        ref_idx, ref_conf = ref.match(j0, j1, image_wh=(W, H))
    s = np_(got.scores(p0, p1, image_wh=(W, H)))
    assert np.isfinite(s).all()
    assert np.abs(s - ref_s).max() <= TOL
    idx, conf = got.match(p0, p1, image_wh=(W, H))
    assert np.array_equal(np_(idx), ref_idx) and (ref_idx >= 0).sum() >= 10
    assert np.abs(np_(conf) - ref_conf).max() <= TOL


def test_feature_matcher_runs_the_network(pair):
    """``LightGlueFeatureMatcher.match_features`` is the network at the
    default image size (640x480); ``match`` with descriptors only is the L2
    ratio test of ``FeatureMatcher``."""
    ref, _ = pair
    m = tmatcher.feature_matcher_factory(norm=NormType.L2,
                                         matcher_type=tmatcher.FeatureMatcherTypes.LIGHTGLUE,
                                         max_distance=1.0, device="cpu")
    assert isinstance(m, tmatcher.LightGlueFeatureMatcher) and m.glue.trained
    d0, xy0, d1, xy1, _ = make_pair(np.random.default_rng(4))
    j0, p0 = _feats(d0, xy0, np.ones(len(d0), bool))
    j1, p1 = _feats(d1, xy1, np.ones(len(d1), bool))
    with jax.enable_x64(False):
        ref_idx, _ = ref.match(j0, j1)
    idx, _ = m.match_features(p0, p1)
    assert np.array_equal(np_(idx), ref_idx)
    plain = tmatcher.FeatureMatcher(norm=NormType.L2)
    assert m.max_distance == plain.max_distance and m.ratio_test == plain.ratio_test
    a, _ = m.match(p0.desc, p1.desc)
    b, _ = plain.match(p0.desc, p1.desc)
    assert torch.equal(a, b)


def test_checkpoint_of_the_flax_layout_loads_in_both(tmp_path):
    """A torch checkpoint named like the flax tree (the JAX package's
    ``generic_from_torch`` layout; dim 64, 2 layers, random weights written
    here) loads into both packages, which then agree."""
    net = interop.seeded_init_(LightGlueNet(dim=64, layers=2, input_dim=256), 9)
    path = str(tmp_path / "lightglue.pth")
    torch.save(net.state_dict(), path)
    got = LightGlueMatcher(dim=64, layers=2, checkpoint=path, device="cpu")
    with jax.enable_x64(False):
        ref = JaxLightGlue(dim=64, layers=2, checkpoint=path)
    d0, xy0, d1, xy1, _ = make_pair(np.random.default_rng(5))
    j0, p0 = _feats(d0, xy0, np.ones(len(d0), bool))
    j1, p1 = _feats(d1, xy1, np.ones(len(d1), bool))
    with jax.enable_x64(False):
        ref_s = _ref_scores(ref, j0, j1)
    assert got.trained
    assert np.abs(np_(got.scores(p0, p1)) - ref_s).max() <= TOL


# ------------------------------------------- tests/test_trained_matcher_vpr.py
def _evaluate(matcher, n_pairs, seed=999):
    """Precision and recall of the mutual-best matches above the threshold
    on held-out pairs (the JAX package's ``train_lightglue.evaluate``)."""
    r = np.random.default_rng(seed)
    tp = fp = fn = 0
    for _ in range(n_pairs):
        d0, xy0, d1, xy1, gt = make_pair(r)
        ones = np.ones(len(d0), bool)
        pred, _ = matcher.match(_feats(d0, xy0, ones)[1], _feats(d1, xy1, ones)[1],
                                image_wh=(W, H))
        pred = np_(pred)
        tp += int(((gt >= 0) & (pred == gt)).sum())
        fp += int(((pred >= 0) & (pred != gt)).sum())
        fn += int(((gt >= 0) & (pred != gt)).sum())
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


def test_trained_lightglue_beats_nn(pair):
    """On 20 held-out ambiguous pairs: precision >= 0.38, recall >= 0.30,
    both more than mutual-NN's + 0.08."""
    _, got = pair
    p, r = _evaluate(got, 20)
    with jax.enable_x64(False):
        nn_p, nn_r = nn_baseline(n_pairs=20)
    assert p >= 0.38 and r >= 0.30, (p, r)
    assert p > nn_p + 0.08 and r > nn_r + 0.08, (p, r, nn_p, nn_r)


def test_random_lightglue_fails_the_same_task(pair):
    _, got = pair
    rand = LightGlueMatcher(dim=96, layers=4, checkpoint="", device="cpu")
    assert not rand.trained
    _, r_t = _evaluate(got, 12)
    _, r_r = _evaluate(rand, 12)
    assert r_t > r_r + 0.2, (r_t, r_r)
