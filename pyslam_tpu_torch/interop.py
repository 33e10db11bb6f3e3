"""Carry state across between the JAX package and the port.

``map_from_tpu_json`` builds the port's ``Map`` from the dict that
``pyslam_tpu.slam.map_serialization.map_to_json`` writes (format
``pyslam_tpu_map_v1``: base64 numpy blocks, bit-packed descriptors) through
the port's reader of that schema (``slam/map_serialization.py``, whose
``map_to_json`` writes maps the JAX package's ``map_from_json`` reads), so
that either package can continue from the other's map.
``voxel_table_from_numpy`` builds the dense state, the voxel-hash table,
from the arrays of the JAX package's table (``TSDFVolume.load`` reads its
``.npz`` through it).
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.ops.voxel_hash import VoxelHashTable
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.slam.map_serialization import map_from_json


def map_from_tpu_json(d: dict, camera, feature_tracker) -> Map:
    """Port ``Map`` on ``feature_tracker.device`` from a native-schema dict
    (``slam.map_serialization.map_from_json``, the one reader)."""
    return map_from_json(d, feature_tracker, camera)


def voxel_table_from_numpy(keys, occupied, tsdf, weight, color, *,
                           device: torch.device | str = "cuda") -> VoxelHashTable:
    """The port's voxel-hash table on ``device`` from the five arrays of a
    ``pyslam_tpu.ops.voxel_hash.VoxelHashTable`` (keys (C,3) int32,
    occupied (C,), tsdf (C,), weight (C,), color (C,3)); the slots keep
    their places, so lookups and later inserts resolve as in the JAX
    package."""
    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)   # a copy of its own

    keys = put(keys, np.int32)
    if keys.ndim != 2 or keys.shape[1] != 3 or keys.shape[0] & (keys.shape[0] - 1):
        raise ValueError(f"keys must be (C,3) with C a power of two, got {tuple(keys.shape)}")
    return VoxelHashTable(keys=keys, occupied=put(occupied, bool), tsdf=put(tsdf, np.float32),
                          weight=put(weight, np.float32), color=put(color, np.float32))
