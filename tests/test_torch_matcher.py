"""Descriptor distances, the plain nearest-neighbour matcher and the feature
matcher of the port against ``pyslam_tpu.ops.hamming``,
``pyslam_tpu.ops.matching.match_nn`` and ``pyslam_tpu.features.matcher``.

Inputs are made from a numpy seed.  Tolerances:
- bit packing, Hamming distances and every match index: identical (the
  Hamming matrices are exact integers; the L2 and cosine matrices feed
  argmins whose gaps here are far above float32 noise, so no tie can flip);
- L2 and cosine distances: within 2e-5 (absolute, on unit-scale
  descriptors): the two float32 matrix products sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.features import matcher as jmatcher
from pyslam_tpu.features.types import NormType as JNorm
from pyslam_tpu.ops import hamming as jham
from pyslam_tpu.ops import matching as jmat
from pyslam_tpu_torch.features import matcher as tmatcher
from pyslam_tpu_torch.features.types import NormType
from pyslam_tpu_torch.ops import hamming as tham
from pyslam_tpu_torch.ops import matching as tmat
from tests.torch_parity import np_, rng, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

SEEDS = [0, 1, 2]


@pytest.mark.parametrize("nbits", [256, 486, 512])
@pytest.mark.parametrize("seed", SEEDS)
def test_pack_unpack_round_trip(seed, nbits):
    bits = rng(seed).integers(0, 2, (40, nbits - nbits % 8)).astype(np.int8)
    packed_ref = np.asarray(jham.pack_bits(jnp.asarray(bits)))
    packed = tham.pack_bits(t(bits))
    assert np.array_equal(np_(packed), packed_ref)
    assert np.array_equal(np_(packed), tham.np_pack(bits))
    assert np.array_equal(np_(tham.unpack_bits(packed)), bits)
    assert np.array_equal(np_(tham.unpack_bits(packed)),
                          np.asarray(jham.unpack_bits(jnp.asarray(packed_ref))))
    assert np.array_equal(tham.np_unpack(tham.np_pack(bits)), bits)


@pytest.mark.parametrize("seed", SEEDS)
def test_hamming_packed(seed):
    r = rng(seed)
    a = r.integers(0, 256, (30, 64)).astype(np.uint8)
    b = r.integers(0, 256, (50, 64)).astype(np.uint8)
    ref = np.asarray(jham.hamming_distance_matrix_packed(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(np_(tham.hamming_distance_matrix_packed(t(a), t(b))),
                          ref.astype(np.float32))


def _float_desc(r, n, d=128):
    x = r.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_l2_and_dispatch(seed):
    r = rng(seed)
    a, b = _float_desc(r, 60), _float_desc(r, 80)
    with jax.enable_x64(False):
        ref = np.asarray(jham.l2_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
        ref_d = np.asarray(jham.descriptor_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = np_(tham.l2_distance_matrix(t(a), t(b)))
    assert np.abs(got - ref).max() < 2e-5
    assert np.array_equal(np_(tham.descriptor_distance_matrix(t(a), t(b))), got)
    assert np.abs(got - ref_d).max() < 2e-5
    bits_a = r.integers(0, 2, (60, 512)).astype(np.int8)
    bits_b = r.integers(0, 2, (80, 512)).astype(np.int8)
    ref_h = np.asarray(jham.descriptor_distance_matrix(jnp.asarray(bits_a), jnp.asarray(bits_b)))
    assert np.array_equal(np_(tham.descriptor_distance_matrix(t(bits_a), t(bits_b))), ref_h)


@pytest.mark.parametrize("seed", SEEDS)
def test_match_nn(seed):
    """Tied small-integer distances: the first index wins in both."""
    r = rng(seed)
    d = r.integers(0, 12, (60, 80)).astype(np.float32)
    va, vb = r.uniform(size=60) > 0.1, r.uniform(size=80) > 0.1
    extra = r.uniform(size=(60, 80)) > 0.3
    ref_i, ref_d = jmat.match_nn(jnp.asarray(d), 4.0, jnp.asarray(va), jnp.asarray(vb),
                                 jnp.asarray(extra))
    got_i, got_d = tmat.match_nn(t(d), 4.0, t(va), t(vb), t(extra))
    assert np.array_equal(np_(got_i), np.asarray(ref_i))
    assert np.array_equal(np_(got_d), np.asarray(ref_d, np.float32))


def _pair(r, norm):
    if norm == "HAMMING":
        a = r.integers(0, 2, (70, 256)).astype(np.int8)
        b = r.integers(0, 2, (90, 256)).astype(np.int8)
        b[:40] = a[:40]
        b[:40, :20] ^= 1      # near copies: distance 20, far pairs ~128
        return a, b, 60.0
    a = _float_desc(r, 70)
    b = _float_desc(r, 90)
    b[:40] = a[:40] + 0.05 * _float_desc(r, 40)
    return a, b, 0.9


@pytest.mark.parametrize("norm", ["HAMMING", "L2", "COSINE"])
@pytest.mark.parametrize("mtype", ["BF", "NN"])
@pytest.mark.parametrize("seed", SEEDS)
def test_feature_matcher(seed, mtype, norm):
    r = rng(seed)
    a, b, gate = _pair(r, norm)
    if norm == "COSINE":
        gate = 0.3
    va = r.uniform(size=len(a)) > 0.05
    vb = r.uniform(size=len(b)) > 0.05
    with jax.enable_x64(False):
        jm = jmatcher.FeatureMatcher(norm=JNorm[norm],
                                     matcher_type=jmatcher.FeatureMatcherTypes[mtype],
                                     max_distance=gate, ratio_test=0.8)
        ref_i, _ = jm.match(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb))
        ref_dm = np.asarray(jm.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    tm = tmatcher.feature_matcher_factory(norm=NormType[norm],
                                          matcher_type=tmatcher.FeatureMatcherTypes[mtype],
                                          max_distance=gate, ratio_test=0.8)
    got_i, _ = tm.match(t(a), t(b), t(va), t(vb))
    assert np.abs(np_(tm.distance_matrix(t(a), t(b))) - ref_dm).max() < 2e-5
    assert np.array_equal(np_(got_i), np.asarray(ref_i))
    assert (np_(got_i) >= 0).sum() >= 30


def test_lightglue_waits_for_the_learned_slice():
    """The learned-model slice brought LightGlue: the factory builds it on
    the CPU with the bundled weights, and it matches a set of keypoints to
    a shifted copy of itself (tests/test_torch_lightglue.py holds it to the
    JAX package)."""
    from types import SimpleNamespace

    m = tmatcher.feature_matcher_factory(norm=NormType.L2,
                                         matcher_type=tmatcher.FeatureMatcherTypes.LIGHTGLUE,
                                         device="cpu")
    assert isinstance(m, tmatcher.LightGlueFeatureMatcher) and m.glue.trained
    r = rng(0)
    desc = _float_desc(r, 64, 256)
    xy = r.uniform(0, 400, (64, 2)).astype(np.float32)
    f1 = SimpleNamespace(desc=t(desc), xy=t(xy), valid=t(np.ones(64, bool)))
    f2 = SimpleNamespace(desc=t(desc), xy=t(xy + 3.0), valid=t(np.ones(64, bool)))
    idx, conf = m.match_features(f1, f2)
    assert idx.shape == (64,) and conf.shape == (64,) and idx.device.type == "cpu"
    assert bool(torch.isfinite(conf).all())


def test_matcher_defaults_follow_parameters():
    from pyslam_tpu_torch.config_parameters import Parameters

    m = tmatcher.FeatureMatcher()
    assert m.max_distance == Parameters.kMaxDescriptorDistance
    assert m.ratio_test == Parameters.kMatchRatioTest == 0.75
    assert isinstance(tham.hamming_distance_matrix(torch.zeros(2, 8, dtype=torch.int8),
                                                   torch.ones(3, 8, dtype=torch.int8)),
                      torch.Tensor)
