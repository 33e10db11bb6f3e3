"""Hamming distances and the masked matchers of the port against
``pyslam_tpu.ops.hamming`` / ``pyslam_tpu.ops.matching``.  Inputs are
small-integer distance matrices full of ties: the port must break them as
the reference does (first index on argmin, lowest row on the one-to-one
resolution, lowest bin on the histogram's top-k).  All outputs here are
discrete and must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.ops import hamming as jham
from pyslam_tpu.ops import matching as jmat
from pyslam_tpu_torch.ops import hamming as tham
from pyslam_tpu_torch.ops import matching as tmat
from tests.torch_parity import f32, np_, rng, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

SEEDS = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_hamming_distance_matrix(seed):
    r = rng(seed)
    a = r.integers(0, 2, (70, 256)).astype(np.int8)
    b = r.integers(0, 2, (90, 256)).astype(np.int8)
    b[:10] = a[:10]
    ref = np.asarray(jham.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = np_(tham.hamming_distance_matrix(t(a), t(b)))
    assert np.array_equal(got, ref.astype(np.float32))


def _tied_problem(seed, n=60, m=80):
    r = rng(seed)
    d = r.integers(0, 12, (n, m)).astype(np.float32)
    va = r.uniform(size=n) > 0.1
    vb = r.uniform(size=m) > 0.1
    extra = r.uniform(size=(n, m)) > 0.3
    return d, va, vb, extra


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cross_check", [True, False])
def test_match_ratio_test(seed, cross_check):
    d, va, vb, extra = _tied_problem(seed)
    ref_idx, ref_d = jmat.match_ratio_test(
        jnp.asarray(d), 8.0, ratio=0.9, valid_a=jnp.asarray(va), valid_b=jnp.asarray(vb),
        cross_check=cross_check, extra_mask=jnp.asarray(extra))
    idx, dist = tmat.match_ratio_test(t(d), 8.0, ratio=0.9, valid_a=t(va), valid_b=t(vb),
                                      cross_check=cross_check, extra_mask=t(extra))
    assert np.array_equal(np_(idx), np.asarray(ref_idx))
    assert np.array_equal(np_(dist), np.asarray(ref_d))
    assert (np_(idx) >= 0).sum() > 0


def test_match_ratio_test_batched_equals_rows():
    ds = [_tied_problem(s)[0] for s in SEEDS]
    idx, _ = tmat.match_ratio_test(t(np.stack(ds)), 8.0, ratio=0.9)
    for b, d in enumerate(ds):
        ref, _ = jmat.match_ratio_test(jnp.asarray(d), 8.0, ratio=0.9)
        assert np.array_equal(np_(idx[b]), np.asarray(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_top2_along_rows(seed):
    d = _tied_problem(seed)[0]
    ref = jmat.top2_along_rows(jnp.asarray(d))
    got = tmat.top2_along_rows(t(d))
    for a, b in zip(ref, got):
        assert np.array_equal(np_(b), np.asarray(a))


@pytest.mark.parametrize("seed", SEEDS)
def test_row_stereo_match(seed):
    r = rng(seed)
    n, m = 50, 55
    xa = r.integers(20, 300, n).astype(np.float32)
    ya = r.integers(10, 200, n).astype(np.float32)
    xb = xa[r.integers(0, n, m)] - r.integers(0, 30, m)
    yb = ya[r.integers(0, n, m)] + r.integers(-2, 3, m)
    d = r.integers(0, 40, (n, m)).astype(np.float32)
    disp = xa[:, None] - xb[None, :]
    va = r.uniform(size=n) > 0.05
    vb = r.uniform(size=m) > 0.05
    kw = dict(max_distance=30.0, row_tol=2.0, min_disp=0.1, max_disp=25.0)
    ref, _ = jmat.row_stereo_match(jnp.asarray(d), jnp.asarray(ya), jnp.asarray(f32(yb)),
                                   jnp.asarray(f32(disp)), valid_a=jnp.asarray(va),
                                   valid_b=jnp.asarray(vb), **kw)
    got, _ = tmat.row_stereo_match(t(d), t(ya), t(yb), t(disp), valid_a=t(va),
                                   valid_b=t(vb), **kw)
    assert np.array_equal(np_(got), np.asarray(ref))
    assert (np.asarray(ref) >= 0).sum() > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_rotation_histogram_filter(seed):
    r = rng(seed)
    n = 120
    # angle differences on exact bin centres: histogram counts tie often
    a = (r.integers(0, 30, n) * 12.0).astype(np.float32)
    b = ((a - r.integers(0, 5, n) * 12.0) % 360.0).astype(np.float32)
    ok = r.uniform(size=n) > 0.2
    ref = jmat.rotation_histogram_filter(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ok))
    got = tmat.rotation_histogram_filter(t(a), t(b), t(ok))
    assert np.array_equal(np_(got), np.asarray(ref))


def test_argmin_keeps_first_index():
    d = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, 0.0, 0.0]])
    assert torch.argmin(d, -1).tolist() == [1, 0]
