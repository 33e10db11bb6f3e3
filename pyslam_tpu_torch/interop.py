"""Carry state across from the JAX package.

``map_from_tpu_json`` builds the port's ``Map`` from the dict that
``pyslam_tpu.slam.map_serialization.map_to_json`` writes (format
``pyslam_tpu_map_v1``: base64 numpy blocks, bit-packed descriptors), decoded
with numpy alone, so that both packages can continue from the same map.
``voxel_table_from_numpy`` builds the dense state, the voxel-hash table,
from the arrays of the JAX package's table (``TSDFVolume.load`` reads its
``.npz`` through it).
"""

from __future__ import annotations

import base64

import numpy as np
import torch

from pyslam_tpu_torch.ops import hamming
from pyslam_tpu_torch.ops.voxel_hash import VoxelHashTable
from pyslam_tpu_torch.slam.frame import Frame, KeyFrame
from pyslam_tpu_torch.slam.map import Map


def _unb64(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"])) \
        .reshape(d["shape"]).copy()


def _desc(d: dict, key: str) -> np.ndarray:
    if f"{key}_float" in d:
        return _unb64(d[f"{key}_float"])
    return hamming.np_unpack(_unb64(d[f"{key}_packed"]))


def map_from_tpu_json(d: dict, camera, feature_tracker) -> Map:
    """Port ``Map`` on ``feature_tracker.device`` from a
    ``pyslam_tpu_map_v1`` dict (keyframes, map points, observations rebuilt
    from the keyframe slots, covisibility and spanning tree)."""
    if d.get("format") != "pyslam_tpu_map_v1":
        raise ValueError(f"unsupported map format: {d.get('format')}")
    m = Map(device=feature_tracker.device)
    st = m.points
    pts = d["points"]
    ids = _unb64(pts["ids"])
    if len(ids) > 0:
        needed = int(ids.max()) + 1
        while st.capacity < needed:
            st._grow()
        st.size = max(st.size, needed, int(d.get("max_point_id", 0)))
        st.pos[ids] = _unb64(pts["pos"])
        desc = _desc(pts, "desc")
        st.ensure_desc_layout(desc)
        st.desc[ids] = desc
        st.normal[ids] = _unb64(pts["normal"])
        st.min_dist[ids] = _unb64(pts["min_dist"])
        st.max_dist[ids] = _unb64(pts["max_dist"])
        st.num_obs[ids] = _unb64(pts["num_obs"])
        st.first_kid[ids] = _unb64(pts["first_kid"])
        st.valid[ids] = True
    for kfd in d["keyframes"]:
        f = Frame(camera, feature_tracker=feature_tracker, frame_id=kfd["id"],
                  timestamp=kfd["timestamp"])
        f.Tcw = np.asarray(kfd["Tcw"], np.float64).reshape(4, 4)
        kps = _unb64(kfd["kps"]).astype(np.float32)
        f.set_host_fields(
            kps=kps, levels=_unb64(kfd["levels"]).astype(np.int32),
            angles=_unb64(kfd["angles"]).astype(np.float32),
            sizes=np.zeros(len(kps), np.float32), valid=_unb64(kfd["valid"]).astype(bool),
            kps_ur=_unb64(kfd["kps_ur"]).astype(np.float32),
            depths=_unb64(kfd["depths"]).astype(np.float32))
        f.des = _desc(kfd, "des")
        f.points = _unb64(kfd["points"]).astype(np.int64)
        kf = KeyFrame(f, kid=kfd["kid"])
        kf.parent = kfd.get("parent")
        kf.children = set(kfd.get("children", []))
        kf.loop_edges = set(kfd.get("loop_edges", []))
        kf.connected_keyframes = {int(k): int(v) for k, v in kfd.get("connected", {}).items()}
        kf._reorder()
        m.add_keyframe(kf)
        for kp_idx in np.nonzero(kf.points >= 0)[0]:
            pid = int(kf.points[kp_idx])
            if pid < st.size and st.valid[pid]:
                m.observations.setdefault(pid, {})[kf.kid] = int(kp_idx)
            else:
                kf.points[kp_idx] = -1
    for pid, obs in m.observations.items():
        st.num_obs[pid] = len(obs)
    return m


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
