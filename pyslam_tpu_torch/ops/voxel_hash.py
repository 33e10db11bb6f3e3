"""Flat open-addressing voxel hash table in device tensors (port of
``pyslam_tpu/ops/voxel_hash.py``).

    keys (C,3) int32 voxel coords | occupied (C,) bool | tsdf (C,) |
    weight (C,) | color (C,3)

Insertion claims slots in ``INSERT_ROUNDS`` fixed rounds: every pending
update scatters its index into its candidate slot with a scatter-min (the
lowest index wins), gathers the ticket back to learn whether it won, and
losers probe on.  All probing runs over a (C,) int32 fingerprint image of
the table (a second spatial hash of the key, 0 for an empty slot), and
fingerprint equality stands in for key equality (see ``lookup``).  Updates
still unresolved after the last round are dropped.  Accumulation is one
packed scatter-add of (w, sdf * w, gray * w) rows, then a blend of the
touched slots.

The hashes are the reference's uint32 arithmetic done in int64: each
product and XOR is masked to 32 bits, and the multiply is split so that no
intermediate overflows int64 (torch has no ``>>`` for uint32 on the CPU).
Scatters whose target is "dropped" in the reference go to an extra last row
of a (C+1,) scratch buffer.  No step reads a value back to the host.

On the card the scatter-add sums in no fixed order, so ``tsdf``, ``weight``
and ``color`` may differ in their last bits between runs; the slots, keys
and ``occupied`` do not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_PROBES = 16
# probe rounds of an insert: a loser racing on a just-claimed slot stalls one
# round before it advances, and updates unresolved within the budget are
# dropped for that depth view; keep the load factor <= 0.25
INSERT_ROUNDS = 6

_MASK32 = 0xFFFFFFFF
_INV_3 = float(np.float32(1.0) / np.float32(3.0))


class VoxelHashTable(NamedTuple):
    keys: torch.Tensor      # (C,3) int32
    occupied: torch.Tensor  # (C,) bool
    tsdf: torch.Tensor      # (C,) float32
    weight: torch.Tensor    # (C,) float32
    color: torch.Tensor     # (C,3) float32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def make_table(capacity: int, *, device: torch.device | str = "cuda") -> VoxelHashTable:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return VoxelHashTable(
        keys=torch.zeros((capacity, 3), dtype=torch.int32, device=device),
        occupied=torch.zeros((capacity,), dtype=torch.bool, device=device),
        tsdf=torch.zeros((capacity,), dtype=torch.float32, device=device),
        weight=torch.zeros((capacity,), dtype=torch.float32, device=device),
        color=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
    )


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant c,
    without an int64 overflow: the high half of c only reaches the low 32
    bits through the low 16 bits of its product."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _spatial_hash(coords: torch.Tensor, c0: int, c1: int, c2: int) -> torch.Tensor:
    """uint32 ``(x*c0) ^ (y*c1) ^ (z*c2)`` of int32 coords, as int64."""
    u = coords.to(torch.int64) & _MASK32     # the reference's int32 -> uint32 cast
    return _mul32(u[..., 0], c0) ^ _mul32(u[..., 1], c1) ^ _mul32(u[..., 2], c2)


def _hash(coords: torch.Tensor, capacity: int) -> torch.Tensor:
    """Teschner spatial hash -> slot index (int64)."""
    return _spatial_hash(coords, 73856093, 19349669, 83492791) & (capacity - 1)


def _fingerprint(coords: torch.Tensor) -> torch.Tensor:
    """Second, independent spatial hash -> nonzero int32 fingerprint (0 marks
    an empty slot, so a key hashing to 0 gets 1).  Values >= 2**31 wrap to
    negative int32, as the reference's ``astype(int32)`` does."""
    h = _spatial_hash(coords, 2654435761, 805459861, 3674653429)
    h = h ^ (h >> 16)
    h = torch.where(h == 0, torch.ones_like(h), h)
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def _table_fingerprints(table: VoxelHashTable) -> torch.Tensor:
    """(C,) fingerprint image of the table (one dense pass)."""
    fp = _fingerprint(table.keys)
    return torch.where(table.occupied, fp, torch.zeros_like(fp))


def lookup(table: VoxelHashTable, coords: torch.Tensor) -> torch.Tensor:
    """(N,3) coords -> (N,) slot index or -1, probing ``MAX_PROBES`` slots
    of the fingerprint image.

    Key equality is tested through the 32-bit fingerprint only: an absent
    coord can resolve to a false-positive slot (and two voxels can alias)
    with probability ~2**-32 per colliding pair.  Callers needing exact
    semantics check ``table.keys[slot] == coord`` themselves."""
    C = table.capacity
    h0 = _hash(coords, C)
    fpt = _table_fingerprints(table)
    fps = _fingerprint(coords)
    found = torch.full(h0.shape, -1, dtype=torch.int64, device=coords.device)
    for i in range(MAX_PROBES):
        slot = (h0 + i) & (C - 1)
        hit = (found < 0) & (fpt[slot] == fps)
        found = torch.where(hit, slot, found)
    return found.to(torch.int32)


def probe_faults(table: VoxelHashTable) -> dict:
    """What a correct insert never leaves in the table, counted over the
    occupied slots (one dense pass of ``MAX_PROBES`` gathers):

    - ``beyond``: a key displaced ``INSERT_ROUNDS`` or more slots from its
      home slot, farther than any claim round probes;
    - ``holes``: an empty slot between a key's home and its slot (a later
      insert of the key would claim the hole: its probe sequence is lost);
    - ``duplicates``: occupied slots whose key another occupied slot holds.

    Also ``aliases`` (an earlier slot on a key's probe sequence holding
    another key with the same fingerprint: ``lookup``'s documented false
    positive, ~2**-32 a pair) and ``max_displacement``."""
    C = table.capacity
    s = torch.nonzero(table.occupied).reshape(-1)
    keys = table.keys[s]
    h = _hash(keys, C)
    d = (s - h) & (C - 1)
    fpt = _table_fingerprints(table)
    fp = fpt[s]
    holes = torch.zeros((), dtype=torch.int64, device=s.device)
    aliases = torch.zeros_like(holes)
    for j in range(MAX_PROBES):
        before = j < d
        slot = (h + j) & (C - 1)
        holes += (before & (fpt[slot] == 0)).sum()
        aliases += (before & (fpt[slot] == fp) & (table.keys[slot] != keys).any(1)).sum()
    n_unique = int(torch.unique(keys, dim=0).shape[0]) if len(s) else 0
    return {"occupied": int(len(s)), "beyond": int((d >= INSERT_ROUNDS).sum()),
            "holes": int(holes), "duplicates": int(len(s)) - n_unique,
            "aliases": int(aliases), "max_displacement": int(d.max()) if len(s) else 0}


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` as XLA's CPU code computes it, contracted into
    a fused multiply-add.  The product of two float32 values is exact in
    float64; the float64 add and the cast back are each correctly rounded,
    on the CPU and the card alike.  That is two roundings, not one: the
    result equals a true fused multiply-add except where the float64 sum
    lands on a float32 rounding midpoint that the exact sum does not (the
    exact sum lies within half a float64 ulp of the midpoint), which the
    parity tests have not met."""
    return (a.double() * b.double() + c.double()).float()


def claim_slots(table: VoxelHashTable, coords: torch.Tensor, valid: torch.Tensor):
    """The insert's ``INSERT_ROUNDS`` claim rounds: (slot_of (N,) int64,
    the slot each valid update resolved to, -1 if it is still unresolved
    and is dropped; won (N,) bool, the updates that claimed an empty slot).
    Duplicate keys in the batch resolve to one slot in the same round."""
    C = table.capacity
    n = coords.shape[0]
    dev = coords.device
    h0 = _hash(coords, C)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    fps = _fingerprint(coords)
    dump = torch.full((n,), C, dtype=torch.int64, device=dev)
    # (C+1,) fingerprint image: the last slot takes the dropped writes
    fpt = torch.cat([_table_fingerprints(table), fps.new_zeros(1)])
    slot_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    probe = torch.zeros((n,), dtype=torch.int64, device=dev)
    won_any = torch.zeros((n,), dtype=torch.bool, device=dev)
    tickets = torch.full((C + 1,), n, dtype=torch.int64, device=dev)
    for _ in range(INSERT_ROUNDS):
        pending = (slot_of < 0) & valid
        slot = (h0 + probe) & (C - 1)
        fslot = fpt[slot]
        # case 1: the slot already holds our key (fingerprint equality)
        take = pending & (fslot == fps)
        slot_of = torch.where(take, slot, slot_of)
        pending = pending & ~take
        # case 2: the slot is empty -> the lowest update index wins it
        want = pending & (fslot == 0)
        want_slot = torch.where(want, slot, dump)
        tickets.scatter_reduce_(0, want_slot, ids, "amin")
        won = want & (tickets[slot] == ids)
        tickets.index_fill_(0, want_slot, n)   # clean for the next round
        fpt.index_put_((torch.where(won, slot, dump),), fps)
        slot_of = torch.where(won, slot, slot_of)
        won_any = won_any | won
        pending = pending & ~won
        # losers of this round's race stay at the same offset: next round
        # sees the winner's fingerprint and binds a duplicate key (case 1)
        probe = torch.where(pending & ~want, probe + 1, probe)
    return slot_of, won_any


def insert_and_accumulate(table: VoxelHashTable, coords: torch.Tensor, sdf: torch.Tensor,
                          w: torch.Tensor, color: torch.Tensor, valid: torch.Tensor,
                          max_weight: float = 200.0) -> VoxelHashTable:
    """Fuse a batch of voxel updates into a new table (running weighted
    average), inserting unseen voxels.

    coords (N,3) int32, sdf (N,), w (N,), color (N,) grey (or (N,3),
    averaged), valid (N,) bool.  Duplicate keys in the batch resolve to one
    slot (``claim_slots``) and their updates are summed by the scatter-add.
    """
    C = table.capacity
    slot_of, won_any = claim_slots(table, coords, valid)
    dump = torch.full_like(slot_of, C)

    # full keys and occupancy are written once, for this batch's claims
    claim = torch.where(won_any, slot_of, dump)

    # accumulate: one packed scatter-add into per-slot accumulators
    tgt = torch.where((slot_of >= 0) & valid, slot_of, dump)
    # an (N,3) color is averaged to grey, as XLA rounds a mean over 3: the
    # sum times the float32 reciprocal of 3
    gray = color if color.dim() == 1 else color.sum(dim=1) * _INV_3
    upd = torch.stack([w, sdf * w, gray * w], dim=1).to(torch.float32)
    acc = torch.zeros((C + 1, 3), dtype=torch.float32, device=upd.device).index_add_(0, tgt, upd)

    # blend the touched slots; every update of a slot computes the same
    # value, and dropped updates write the extra last row
    wsum, twsum, gsum = acc[tgt].unbind(1)
    s = tgt.clamp(max=C - 1)
    w_old, tsdf_old, color_old = table.weight[s], table.tsdf[s], table.color[s]
    touched = wsum > 0
    denom = torch.clamp(w_old + wsum, min=1e-9)
    tsdf_new = torch.where(touched, fma32(tsdf_old, w_old, twsum) / denom, tsdf_old)
    weight_new = torch.where(touched, torch.clamp(w_old + wsum, max=max_weight), w_old)
    color_new = torch.where(touched[:, None],
                            fma32(color_old, w_old[:, None], gsum[:, None]) / denom[:, None],
                            color_old)

    def put(old: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        out = torch.cat([old, old.new_zeros((1,) + old.shape[1:])])
        return out.index_put_((idx,), val)[:C]

    return VoxelHashTable(keys=put(table.keys, claim, coords.to(torch.int32)),
                          occupied=put(table.occupied, claim, torch.ones_like(won_any)),
                          tsdf=put(table.tsdf, tgt, tsdf_new),
                          weight=put(table.weight, tgt, weight_new),
                          color=put(table.color, tgt, color_new))


def gather_values(table: VoxelHashTable, coords: torch.Tensor):
    """(tsdf, weight) at coords, 0 where absent (``lookup``'s fingerprint
    contract applies)."""
    slots = lookup(table, coords).to(torch.int64)
    ok = slots >= 0
    s = torch.where(ok, slots, torch.zeros_like(slots))
    zero = table.tsdf.new_zeros(())
    return torch.where(ok, table.tsdf[s], zero), torch.where(ok, table.weight[s], zero)
