"""The port's voxel-hash table against ``pyslam_tpu.ops.voxel_hash`` on the
same numpy inputs, the reference with x64 off as the JAX package runs.

What must be equal, and the tolerance of the rest:
- the slot hash and the fingerprint, bit for bit, on negative coordinates,
  on coordinates at the ends of int32 and on fingerprints that wrap past
  2**31 to negative int32 (and the key that hashes to 0 gets 1);
- after ``insert_and_accumulate``: keys and ``occupied`` of every slot,
  with duplicate keys in one batch, foreign keys racing on one slot, and a
  table so full that updates are dropped after the 6 claim rounds;
- ``tsdf``, ``weight`` and ``color``, bit for bit on the CPU (tolerance 0):
  the CPU scatter-add sums in update order as XLA's does, and the blend
  ``(tsdf * w_old + twsum) / denom`` is rounded as XLA contracts it, into
  one fused multiply-add (measured: without that, an ulp on some slots of
  a second batch);
- ``lookup`` slots and ``gather_values``, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)
from pyslam_tpu.ops import voxel_hash as J
from pyslam_tpu_torch.ops import voxel_hash as T
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

FIELDS = ("keys", "occupied", "tsdf", "weight", "color")


def _coords_edge_cases():
    r = np.random.default_rng(0)
    big = np.iinfo(np.int32)
    edge = np.array([[0, 0, 0], [big.min, big.max, -1], [big.max, big.max, big.max],
                     [big.min, big.min, big.min], [-1, -1, -1], [1, -1, 0]], np.int32)
    return np.concatenate([edge, r.integers(big.min, big.max, (3000, 3), endpoint=True),
                           r.integers(-60, 60, (3000, 3))]).astype(np.int32)


@pytest.mark.parametrize("capacity", [1 << 4, 1 << 12, 1 << 22])
def test_slot_hash_bit_equal(capacity):
    c = _coords_edge_cases()
    with jax.enable_x64(False):
        ref = np.asarray(J._hash(jnp.asarray(c), capacity))
    got = T._hash(torch.from_numpy(c), capacity).numpy()
    assert np.array_equal(got, ref)
    assert got.min() >= 0 and got.max() < capacity


def test_fingerprint_bit_equal_with_wrap_and_zero():
    c = _coords_edge_cases()
    with jax.enable_x64(False):
        ref = np.asarray(J._fingerprint(jnp.asarray(c)))
    got = T._fingerprint(torch.from_numpy(c))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert (ref < 0).any(), "no fingerprint wrapped past 2**31"
    assert got[0] == 1, "the key hashing to 0 must get fingerprint 1"
    assert (got != 0).all()


def _batch(r, n, lo, hi, valid_share=0.9):
    return (r.integers(lo, hi, (n, 3)).astype(np.int32),
            r.uniform(-1, 1, n).astype(np.float32), r.uniform(0.2, 1, n).astype(np.float32),
            r.uniform(0, 1, n).astype(np.float32), r.random(n) < valid_share)


def _colliding(capacity, n_groups, per_group, r):
    """Distinct keys in groups that share one home slot (foreign keys that
    race for the same empty slot)."""
    cand = r.integers(-400, 400, (60000, 3)).astype(np.int32)
    cand = np.unique(cand, axis=0)
    with jax.enable_x64(False):
        home = np.asarray(J._hash(jnp.asarray(cand), capacity))
    out = []
    for h in np.unique(home):
        grp = cand[home == h]
        if len(grp) >= per_group:
            out.append(grp[:per_group])
        if len(out) == n_groups:
            break
    return np.concatenate(out)


def _scenarios():
    r = np.random.default_rng(7)
    yield "duplicates", 1 << 12, [_batch(r, 6000, -8, 8)]
    race = _colliding(1 << 10, 40, 5, r)
    order = r.permutation(len(race))
    n = len(race)
    yield "foreign_race", 1 << 10, [(np.concatenate([race[order], race[order][::-1]]),
                                     r.uniform(-1, 1, 2 * n).astype(np.float32),
                                     r.uniform(0.2, 1, 2 * n).astype(np.float32),
                                     r.uniform(0, 1, 2 * n).astype(np.float32),
                                     np.ones(2 * n, bool))]
    yield "full_table_drops", 1 << 8, [_batch(r, 3000, -40, 40, valid_share=1.0)]
    yield "two_batches", 1 << 14, [_batch(r, 20000, -30, 30), _batch(r, 20000, -25, 35)]
    yield "rgb_color", 1 << 12, [(*_batch(r, 4000, -10, 10)[:3],
                                  r.uniform(0, 1, (4000, 3)).astype(np.float32),
                                  np.ones(4000, bool))]


SCENARIOS = list(_scenarios())


@pytest.mark.parametrize("name,capacity,batches", SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_insert_and_accumulate_slot_exact(name, capacity, batches):
    tj = J.make_table(capacity)
    tt = T.make_table(capacity, device="cpu")
    for coords, sdf, w, col, valid in batches:
        with jax.enable_x64(False):
            tj = J.insert_and_accumulate(tj, jnp.asarray(coords), jnp.asarray(sdf),
                                         jnp.asarray(w), jnp.asarray(col), jnp.asarray(valid))
        tt = T.insert_and_accumulate(tt, torch.from_numpy(coords), torch.from_numpy(sdf),
                                     torch.from_numpy(w), torch.from_numpy(col),
                                     torch.from_numpy(valid))
        for f in FIELDS:
            ref, got = np.asarray(getattr(tj, f)), getattr(tt, f).numpy()
            assert got.dtype == ref.dtype, f
            assert np.array_equal(got, ref), f"{name}: {f}"
    occ = np.asarray(tj.occupied)
    if name == "full_table_drops":
        # more distinct keys than slots: the table fills and the rest drop
        assert occ.all()
        n_keys = len(np.unique(batches[0][0], axis=0))
        assert n_keys > capacity
    if name == "foreign_race":
        # each group's home slot is claimed; losers stall a round on each
        # claimed slot, so some keys are still unresolved after 6 rounds
        assert 40 <= occ.sum() < len(np.unique(batches[0][0], axis=0))


def test_lookup_and_gather_values_equal():
    r = np.random.default_rng(3)
    coords, sdf, w, col, valid = _batch(r, 5000, -20, 20)
    with jax.enable_x64(False):
        tj = J.insert_and_accumulate(J.make_table(1 << 13), jnp.asarray(coords),
                                     jnp.asarray(sdf), jnp.asarray(w), jnp.asarray(col),
                                     jnp.asarray(valid))
    tt = T.insert_and_accumulate(T.make_table(1 << 13, device="cpu"), torch.from_numpy(coords),
                                 torch.from_numpy(sdf), torch.from_numpy(w),
                                 torch.from_numpy(col), torch.from_numpy(valid))
    query = np.concatenate([coords, coords + 1000, r.integers(-25, 25, (500, 3))]).astype(np.int32)
    with jax.enable_x64(False):
        slots = np.asarray(J.lookup(tj, jnp.asarray(query)))
        tsdf, wt = (np.asarray(x) for x in J.gather_values(tj, jnp.asarray(query)))
    got = T.lookup(tt, torch.from_numpy(query))
    assert np.array_equal(got.numpy(), slots)
    assert (slots[len(coords):len(coords) * 2] == -1).all()
    gt, gw = T.gather_values(tt, torch.from_numpy(query))
    assert np.array_equal(gt.numpy(), tsdf) and np.array_equal(gw.numpy(), wt)


def test_roundtrip_and_duplicate_average():
    """The reference's own checks (tests/test_tsdf.py) on the port."""
    r = np.random.default_rng(0)
    coords = np.unique(r.integers(-100, 100, (500, 3)).astype(np.int32), axis=0)
    n = len(coords)
    tab = T.insert_and_accumulate(T.make_table(1 << 14, device="cpu"), torch.from_numpy(coords),
                                  torch.full((n,), 0.5), torch.ones(n), torch.zeros(n, 3),
                                  torch.ones(n, dtype=torch.bool))
    tsdf, w = T.gather_values(tab, torch.from_numpy(coords))
    assert torch.allclose(tsdf, torch.tensor(0.5)) and torch.allclose(w, torch.tensor(1.0))
    assert T.gather_values(tab, torch.from_numpy(coords + 1000))[1].max() == 0.0

    dup = torch.tensor([[3, 4, 5]] * 4, dtype=torch.int32)
    tab = T.insert_and_accumulate(T.make_table(1 << 12, device="cpu"), dup,
                                  torch.tensor([0.0, 1.0, 1.0, 2.0]), torch.ones(4),
                                  torch.zeros(4, 3), torch.ones(4, dtype=torch.bool))
    t_, w_ = T.gather_values(tab, dup[:1])
    assert abs(float(t_[0]) - 1.0) < 1e-6 and abs(float(w_[0]) - 4.0) < 1e-6
    tab = T.insert_and_accumulate(tab, dup[:1], torch.tensor([3.0]), torch.tensor([4.0]),
                                  torch.zeros(1, 3), torch.ones(1, dtype=torch.bool))
    t_, w_ = T.gather_values(tab, dup[:1])
    assert abs(float(t_[0]) - 2.0) < 1e-6 and abs(float(w_[0]) - 8.0) < 1e-6


def test_table_from_numpy_keeps_slots():
    """``interop.voxel_table_from_numpy`` carries the JAX table across: the
    port's lookups and further inserts resolve as the reference's."""
    from pyslam_tpu_torch.interop import voxel_table_from_numpy

    r = np.random.default_rng(5)
    b1, b2 = _batch(r, 3000, -15, 15), _batch(r, 3000, -12, 18)
    with jax.enable_x64(False):
        tj = J.insert_and_accumulate(J.make_table(1 << 12), *map(jnp.asarray, b1))
    tt = voxel_table_from_numpy(*(np.asarray(getattr(tj, f)) for f in FIELDS), device="cpu")
    with jax.enable_x64(False):
        tj = J.insert_and_accumulate(tj, *map(jnp.asarray, b2))
    tt = T.insert_and_accumulate(tt, *map(torch.from_numpy, b2))
    for f in FIELDS:
        assert np.array_equal(getattr(tt, f).numpy(), np.asarray(getattr(tj, f))), f
    with pytest.raises(ValueError):
        voxel_table_from_numpy(np.zeros((6, 3)), np.zeros(6), np.zeros(6), np.zeros(6),
                               np.zeros((6, 3)), device="cpu")
