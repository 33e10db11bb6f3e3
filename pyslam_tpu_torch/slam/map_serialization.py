"""Map JSON serialization, the native schema (port of
``pyslam_tpu/slam/map_serialization.py``; format ``pyslam_tpu_map_v1``).

Schema: keyframes carry poses + keypoint arrays + descriptors (base64) +
per-slot point ids; map points carry positions/normals/ranges;
observations are rebuilt from the keyframe slots on load (dicts and the
map's native mirror).  Binary
descriptors (0/1 bit-planes) are bit-packed at this boundary, float
descriptors stored raw.  The files are the JAX package's: either package
reads what the other writes.

Loading builds every keyframe with the session's feature tracker, so the
map and its keyframes live on the tracker's device.  One departure from the
reference: a bit-packed descriptor is unpacked to a multiple of 8 columns,
so the reference restores AKAZE's 486 bits as 488 and adopts that width for
the session; the port trims the columns to the tracker's descriptor width
(``desc_bits`` of its extractor).
"""

from __future__ import annotations

import base64

import numpy as np

from pyslam_tpu_torch.slam.frame import Frame, KeyFrame
from pyslam_tpu_torch.slam.map import Map

FORMAT = "pyslam_tpu_map_v1"


def _b64(arr: np.ndarray) -> dict:
    return {
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "data": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode(),
    }


def _unb64(d: dict) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"])
    ).reshape(d["shape"]).copy()


def desc_bits(feature_tracker) -> int | None:
    """The tracker's binary descriptor width where it is not a multiple of 8
    (AKAZE's 486 bits), else None."""
    return getattr(getattr(feature_tracker, "extractor", None), "desc_bits", None)


def _desc_to_json(des: np.ndarray, key: str = "desc") -> dict:
    """Binary descriptors (int8 unpacked bits) -> bit-packed b64; float
    descriptors -> raw b64."""
    if np.issubdtype(des.dtype, np.floating):
        return {f"{key}_float": _b64(des.astype(np.float32))}
    return {f"{key}_packed": _b64(np.packbits(des.astype(np.uint8), axis=1))}


def _desc_from_json(d: dict, key: str = "desc", bits: int | None = None) -> np.ndarray:
    """The descriptor block; unpacked bits trimmed to ``bits`` columns when
    given (the packing pads a row to whole bytes)."""
    if f"{key}_float" in d:
        return _unb64(d[f"{key}_float"])
    des = np.unpackbits(_unb64(d[f"{key}_packed"]), axis=1).astype(np.int8)
    return des[:, :bits] if bits is not None else des


def map_to_json(m: Map) -> dict:
    st = m.points
    alive = st.alive_ids()
    points = {
        "ids": _b64(alive.astype(np.int64)),
        "pos": _b64(st.pos[alive]),
        **_desc_to_json(st.desc[alive]),
        "normal": _b64(st.normal[alive]),
        "min_dist": _b64(st.min_dist[alive]),
        "max_dist": _b64(st.max_dist[alive]),
        "num_obs": _b64(st.num_obs[alive]),
        "first_kid": _b64(st.first_kid[alive]),
    }
    keyframes = []
    for kid in m.keyframe_order:
        kf = m.keyframes[kid]
        keyframes.append(
            {
                "kid": kf.kid,
                "id": kf.id,
                "timestamp": kf.timestamp,
                "Tcw": kf.Tcw.reshape(-1).tolist(),
                "kps": _b64(kf.kps),
                "levels": _b64(kf.levels),
                "angles": _b64(kf.angles),
                **_desc_to_json(kf.des, key="des"),
                "valid": _b64(kf.valid),
                "points": _b64(kf.points),
                "kps_ur": _b64(kf.kps_ur),
                "depths": _b64(kf.depths),
                "parent": kf.parent,
                "children": sorted(kf.children),
                "loop_edges": sorted(kf.loop_edges),
                "connected": kf.connected_keyframes,
            }
        )
    return {
        "format": FORMAT,
        "points": points,
        "keyframes": keyframes,
        "max_point_id": int(st.size),
    }


def map_from_json(d: dict, feature_tracker, camera) -> Map:
    """The port's ``Map`` on ``feature_tracker.device`` from a native dict
    (written by either package): keyframes, map points, observations rebuilt
    from the keyframe slots, covisibility and spanning tree.  New point ids
    continue after the saved session's (``max_point_id``)."""
    if d.get("format") != FORMAT:
        raise ValueError(f"unsupported map format: {d.get('format')}")
    bits = desc_bits(feature_tracker)
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
        desc = _desc_from_json(pts, bits=bits)
        st.ensure_desc_layout(desc)
        st.desc[ids] = desc
        st.normal[ids] = _unb64(pts["normal"])
        st.min_dist[ids] = _unb64(pts["min_dist"])
        st.max_dist[ids] = _unb64(pts["max_dist"])
        st.num_obs[ids] = _unb64(pts["num_obs"])
        st.first_kid[ids] = _unb64(pts["first_kid"])
        st.valid[ids] = True
    max_fid = -1
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
        f.des = _desc_from_json(kfd, key="des", bits=bits)
        f.points = _unb64(kfd["points"]).astype(np.int64)
        kf = KeyFrame(f, kid=kfd["kid"])
        kf.parent = kfd.get("parent")
        kf.children = set(kfd.get("children", []))
        kf.loop_edges = set(kfd.get("loop_edges", []))
        kf.connected_keyframes = {int(k): int(v) for k, v in kfd.get("connected", {}).items()}
        kf._reorder()
        m.add_keyframe(kf)
        max_fid = max(max_fid, kf.id)
        m.restore_observations(kf)
    for pid, obs in m.observations.items():
        st.num_obs[pid] = len(obs)
    Frame._id_counter = max(Frame._id_counter, max_fid + 1)
    return m
