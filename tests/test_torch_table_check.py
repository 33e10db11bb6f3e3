"""chip_smoke.py's check of the dense result (``check_table``, phases 7
and 13) on small tables made on the CPU: a table filled by correct inserts
passes, and the check fails on a lost probe sequence (a hole before a key,
a key displaced beyond the claim rounds, a key in two slots), on a table
fuller than its integrated keyframes can fill, and on a drop share over
``DROP_MAX``.  ``voxel_hash.probe_faults`` counts the faults."""

import numpy as np
import pytest
import torch

import chip_smoke
from pyslam_tpu_torch.ops import voxel_hash
from tests.torch_parity import rng

CAPACITY = 1 << 12


def _frames(n=3, per=300):
    """Each frame: a block of distinct voxel coordinates, half of them
    shared with the previous frame."""
    r = rng(0)
    base = r.integers(-200, 200, (1, 3))
    out = []
    for k in range(n):
        c = base + np.stack(np.unravel_index(np.arange(per) + k * per // 2, (20, 20, 20)), 1)
        out.append(torch.as_tensor(c, dtype=torch.int32))
    return out


def _filled(frames):
    table = voxel_hash.make_table(CAPACITY, device="cpu")
    for c in frames:
        n = c.shape[0]
        table = voxel_hash.insert_and_accumulate(
            table, c, torch.zeros(n), torch.ones(n), torch.full((n,), 128.0),
            torch.ones(n, dtype=torch.bool))
    return table


@pytest.fixture(scope="module")
def filled():
    frames = _frames()
    return _filled(frames), [int(torch.unique(c, dim=0).shape[0]) for c in frames]


def _copy(table):
    return voxel_hash.VoxelHashTable(*(x.clone() for x in table))


def test_correct_inserts_pass(filled):
    table, per_frame = filled
    out = chip_smoke.check_table(table, 3, per_frame, 0.0)
    assert out["beyond"] == out["holes"] == out["duplicates"] == 0
    assert out["occupied"] == 600 and out["load"] <= out["load_ceiling"]
    assert out["max_displacement"] >= 1      # the table has probe chains to break


def _displaced(table):
    """Slots whose key sits past its home slot, and their homes."""
    s = torch.nonzero(table.occupied).reshape(-1)
    h = voxel_hash._hash(table.keys[s], table.capacity)
    d = (s - h) & (table.capacity - 1)
    return s[d > 0], h[d > 0]


def test_lost_probe_sequence_fails(filled):
    table, per_frame = filled
    slots, homes = _displaced(table)
    broken = _copy(table)
    broken.occupied[homes[0]] = False                  # a hole at a key's home
    assert voxel_hash.probe_faults(broken)["holes"] >= 1
    with pytest.raises(AssertionError):
        chip_smoke.check_table(broken, 3, per_frame, 0.0)


def test_key_beyond_the_claim_rounds_fails(filled):
    table, per_frame = filled
    C = table.capacity
    broken = _copy(table)
    s = int(torch.nonzero(broken.occupied)[0])
    key = broken.keys[s].clone()
    h = int(voxel_hash._hash(key[None], C)[0])
    far = (h + voxel_hash.INSERT_ROUNDS + 3) & (C - 1)
    assert not bool(broken.occupied[far])
    broken.occupied[s] = False                          # the key moves past its rounds
    broken.keys[far], broken.occupied[far] = key, True
    faults = voxel_hash.probe_faults(broken)
    assert faults["beyond"] == 1
    with pytest.raises(AssertionError):
        chip_smoke.check_table(broken, 3, per_frame, 0.0)


def test_key_in_two_slots_fails(filled):
    table, per_frame = filled
    broken = _copy(table)
    s = int(torch.nonzero(broken.occupied)[0])
    free = int(torch.nonzero(~broken.occupied)[0])
    broken.keys[free], broken.occupied[free] = broken.keys[s], True
    assert voxel_hash.probe_faults(broken)["duplicates"] == 1
    with pytest.raises(AssertionError):
        chip_smoke.check_table(broken, 3, per_frame, 0.0)


def test_over_full_table_fails(filled):
    """Three frames' voxels where one keyframe was integrated, and a drop
    share over DROP_MAX."""
    table, per_frame = filled
    with pytest.raises(AssertionError):
        chip_smoke.check_table(table, 1, per_frame, 0.0)
    with pytest.raises(AssertionError):
        chip_smoke.check_table(table, 3, per_frame, chip_smoke.DROP_MAX + 1e-3)


def test_load_ceiling_takes_the_fullest_frames():
    assert chip_smoke.load_ceiling([10, 40, 20, 30], 2, 100) == pytest.approx(
        70 * (1 + chip_smoke.KF_VOXEL_MARGIN) / 100)
    assert np.isclose(chip_smoke.load_ceiling([10, 40], 5, 100),
                      50 * (1 + chip_smoke.KF_VOXEL_MARGIN) / 100)
