"""Reference-schema map.json interop (port of
``pyslam_tpu/slam/map_serialization_ref.py``).

Emits and parses the reference's cross-core single-file ``map.json`` (pySLAM
``pyslam/slam/map.py:945-1070`` ``Map.to_json/from_json``, per-class layouts
``frame.py:657``, ``keyframe.py:78,373``, ``map_point.py:411``,
``camera.py:323``, wrapped by ``slam.py:334-398`` ``save_system_state``) so
maps can round-trip between this framework and the reference.  The native
compact format (``map_serialization.py``) remains the default; this module is
the compatibility boundary.  Loading builds every keyframe with the
session's feature tracker, so the map lives on the tracker's device; the
keypoint fields are kept in float32 (the port's frame layout) and bit-packed
descriptors are trimmed to the tracker's width (``desc_bits``).

Array encodings mirror the reference helpers
(``pyslam/utilities/serialization.py``):

- ``NumpyB64Json``: ``{"type": "npB64", "dtype", "shape", "order", "data"}``
  with base64 payload — frame/keyframe descriptor blocks.
- ``cv_mat_to_json_raw``: ``{"type": "npRaw", "dtype", "shape", "data"}``
  with a plain JSON list payload — map-point descriptors.
- plain nested lists for poses/keypoint arrays.
"""

from __future__ import annotations

import base64

import numpy as np

from pyslam_tpu_torch.slam.frame import Frame, KeyFrame
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.slam.map_serialization import desc_bits

# --------------------------------------------------------------- encodings

_NP_RAW_DTYPES = {
    "uint8": np.uint8, "int8": np.int8, "uint16": np.uint16,
    "int16": np.int16, "int32": np.int32, "float32": np.float32,
    "float64": np.float64,
}


def np_to_b64json(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {
        "data": base64.b64encode(arr.tobytes()).decode("utf-8"),
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "order": "C",
        "type": "npB64",
    }


def b64json_to_np(d) -> np.ndarray | None:
    if d is None:
        return None
    raw = base64.b64decode(d["data"])
    arr = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
    if d.get("order", "C") == "F":
        return arr.reshape(d["shape"], order="F").copy()
    return arr.reshape(d["shape"]).copy()


def np_to_rawjson(arr: np.ndarray) -> dict | None:
    if arr is None or arr.size == 0:
        return None
    arr = np.ascontiguousarray(arr)
    name = arr.dtype.name if arr.dtype.name in _NP_RAW_DTYPES else "uint8"
    shape = [int(arr.shape[0]), 1] if arr.ndim == 1 else [int(s) for s in arr.shape]
    return {
        "type": "npRaw",
        "dtype": name,
        "shape": shape,
        "data": arr.flatten().tolist(),
    }


def rawjson_to_np(d) -> np.ndarray | None:
    if d is None:
        return None
    arr = np.asarray(d["data"], dtype=_NP_RAW_DTYPES.get(d["dtype"], np.uint8))
    return arr.reshape(d["shape"])


def _any_array(d) -> np.ndarray | None:
    """Parse whichever array encoding the producer used (reference readers
    are equally lenient, e.g. ``deserialize_array_flexible``)."""
    if d is None:
        return None
    if isinstance(d, dict):
        if d.get("type") == "npB64":
            return b64json_to_np(d)
        if d.get("type") == "npRaw":
            return rawjson_to_np(d)
        return None
    return np.asarray(d)


# ------------------------------------------------------------- descriptors

def _des_out(des: np.ndarray, raw: bool):
    """Our in-memory binary descriptors are unpacked bit-planes (N, 8*B)
    int8; the reference stores packed uint8 (N, B) cv-style rows.  Float
    descriptors pass through as float32."""
    if des is None:
        return None
    if np.issubdtype(des.dtype, np.floating):
        out = des.astype(np.float32)
    else:
        out = np.packbits(des.astype(np.uint8), axis=-1)
    return np_to_rawjson(out) if raw else np_to_b64json(out)


def _des_in(d, bits: int | None = None) -> np.ndarray | None:
    des = _any_array(d)
    if des is None:
        return None
    if np.issubdtype(des.dtype, np.floating):
        return des.astype(np.float32)
    des = np.unpackbits(des.astype(np.uint8), axis=-1).astype(np.int8)
    return des[..., :bits] if bits is not None else des


# ----------------------------------------------------------------- camera

def camera_to_reference_json(cam) -> dict:
    import json as _json

    return {
        "type": 0,  # CameraType.PINHOLE
        "width": int(cam.width),
        "height": int(cam.height),
        "fx": float(cam.fx), "fy": float(cam.fy),
        "cx": float(cam.cx), "cy": float(cam.cy),
        "D": _json.dumps(np.asarray(cam.D, float).tolist()),
        "fps": int(cam.fps) if cam.fps else 30,
        "bf": float(cam.bf),
        "b": float(cam.b),
        "depth_factor": float(getattr(cam, "depth_factor", 1.0) or 1.0),
        "depth_threshold": float(cam.depth_threshold)
        if cam.depth_threshold is not None else None,
        "is_distorted": bool(np.any(np.asarray(cam.D) != 0)),
        "u_min": float(cam.u_min), "u_max": float(cam.u_max),
        "v_min": float(cam.v_min), "v_max": float(cam.v_max),
        "initialized": True,
        "K": _json.dumps(np.asarray(cam.K, float).tolist()),
        "Kinv": _json.dumps(np.linalg.inv(np.asarray(cam.K, float)).tolist()),
        "sensor_type": None,
    }


def camera_from_reference_json(d):
    import json as _json

    from pyslam_tpu_torch.slam.camera import PinholeCamera

    if isinstance(d, str):
        d = _json.loads(d)
    D = d.get("D")
    if isinstance(D, str):
        D = _json.loads(D)
    return PinholeCamera(
        int(d["width"]), int(d["height"]),
        float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
        D=None if D is None else np.asarray(D, float),
        fps=d.get("fps") or 30,
        bf=float(d.get("bf") or 0.0),
        depth_threshold=d.get("depth_threshold"),
    )


# -------------------------------------------------------------- keyframes

def _keyframe_to_reference_json(m: Map, kf: KeyFrame, cam) -> dict:
    n = len(kf.kps)
    kpsn = np.asarray(cam.unproject_points(kf.kps))
    # frame-id keyed graph links (reference KeyFrameGraph.to_json uses
    # KeyFrame.id, keyframe.py:78-95)
    def fid(kid):
        kf2 = m.keyframes.get(kid)
        return int(kf2.id) if kf2 is not None else None

    conn = [
        (fid(k), int(w)) for k, w in kf.connected_keyframes.items()
        if fid(k) is not None
    ]
    depths = np.asarray(kf.depths, float)
    pos_depths = depths[depths > 0]
    return {
        "id": int(kf.id),
        "timestamp": float(kf.timestamp),
        "img_id": int(kf.id),
        "pose": np.asarray(kf.Tcw, float).tolist(),
        "camera": camera_to_reference_json(cam),
        "is_keyframe": True,
        "median_depth": float(np.median(pos_depths)) if len(pos_depths) else -1.0,
        "fov_center_c": None,
        "fov_center_w": None,
        "is_blurry": False,
        "laplacian_var": None,
        "kps": np.asarray(kf.kps, float).tolist(),
        "kps_r": None,
        "kpsu": np.asarray(kf.kps, float).tolist(),
        "kpsn": kpsn.astype(float).tolist(),
        "kps_sem": None,
        "octaves": np.asarray(kf.levels).tolist(),
        "octaves_r": None,
        "sizes": np.asarray(getattr(kf, "sizes", np.zeros(n)), float).tolist(),
        "angles": np.asarray(kf.angles, float).tolist(),
        "des": _des_out(kf.des, raw=False),
        "des_r": None,
        "depths": depths.tolist() if len(depths) else None,
        "kps_ur": np.asarray(kf.kps_ur, float).tolist(),
        "points": [int(p) for p in kf.points],
        "outliers": np.asarray(kf.outliers, bool).tolist(),
        "kf_ref": -1,
        "img": None, "depth_img": None, "img_right": None,
        "semantic_img": None, "semantic_instances_img": None,
        "mask": None, "mask_right": None,
        # KeyFrame extras (keyframe.py:373)
        "kid": int(kf.kid),
        "_is_bad": bool(kf.is_bad),
        "lba_count": int(kf.lba_count),
        "to_be_erased": False,
        "_pose_Tcp": None,
        "is_Tcw_GBA_valid": False,
        "loop_query_id": None, "num_loop_words": 0, "loop_score": None,
        "reloc_query_id": None, "num_reloc_words": 0, "reloc_score": None,
        "GBA_kf_id": 0, "Tcw_GBA": None, "Tcw_before_GBA": None,
        # KeyFrameGraph (keyframe.py:78)
        "parent": fid(kf.parent) if kf.parent is not None else None,
        "children": [f for f in (fid(k) for k in sorted(kf.children))
                     if f is not None],
        "loop_edges": [f for f in (fid(k) for k in sorted(kf.loop_edges))
                       if f is not None],
        "init_parent": False,
        "not_to_erase": bool(kf.not_to_erase),
        "connected_keyframes_weights": conn,
        "ordered_keyframes_weights": sorted(conn, key=lambda t: -t[1]),
        "is_first_connection": False,
    }


# ------------------------------------------------------------- public API

def map_to_reference_json(m: Map, camera, sensor_type=None,
                          feature_tracker_config=None) -> dict:
    """Full reference ``map.json`` content (``slam.py:334-398`` wrapper +
    ``map.py:945`` map body)."""
    st = m.points
    alive = st.alive_ids()
    kf_by_kid = m.keyframes

    points_json = []
    for pid in alive:
        pid = int(pid)
        obs = [
            (int(kf_by_kid[kid].id), int(idx))
            for kid, idx in m.observations.get(pid, {}).items()
            if kid in kf_by_kid
        ]
        points_json.append({
            "id": pid,
            "_observations": obs,
            "_frame_views": [],
            "_is_bad": False,
            "_num_observations": len(obs),
            "num_times_visible": int(st.n_visible[pid]),
            "num_times_found": int(st.n_found[pid]),
            "last_frame_id_seen": -1,
            "pt": st.pos[pid].astype(float).tolist(),
            "color": [255, 255, 255],
            "semantic_des": None,
            "semantic_color": None,
            "des": _des_out(st.desc[pid:pid + 1], raw=True),
            "_min_distance": float(st.min_dist[pid]),
            "_max_distance": float(st.max_dist[pid])
            if np.isfinite(st.max_dist[pid]) else 1e9,
            "normal": st.normal[pid].astype(float).tolist(),
            "first_kid": int(st.first_kid[pid]),
            "kf_ref": -1,
        })

    keyframes_json = [
        _keyframe_to_reference_json(m, m.keyframes[kid], camera)
        for kid in m.keyframe_order
    ]
    first = m.keyframe_order[0] if m.keyframe_order else None

    map_json = {
        "FrameBase._id": int(m.max_frame_id) + 1,
        "MapPointBase._id": int(st.size),
        "frames": [],
        "keyframes": keyframes_json,
        "points": points_json,
        "keyframe_origins": (
            [keyframes_json[0]] if first is not None else []
        ),
        "max_frame_id": int(m.max_frame_id),
        "max_point_id": int(st.size),
        "max_keyframe_id": int(m.max_keyframe_id),
        "viewer_scale": -1,
    }
    return {
        "USE_CPP_CORE": False,
        "sensor_type": sensor_type.name if sensor_type is not None else None,
        "environment_type": None,
        "map": map_json,
        "feature_tracker_config": (
            feature_tracker_config.to_json()
            if feature_tracker_config is not None
            and hasattr(feature_tracker_config, "to_json") else None
        ),
        "loop_detector_config": None,
        "semantic_mapping_config": None,
    }


def is_reference_schema(d: dict) -> bool:
    body = d.get("map", d)
    return isinstance(body, dict) and isinstance(body.get("keyframes"), list) and (
        not body["keyframes"] or isinstance(body["keyframes"][0], dict)
        and "pose" in body["keyframes"][0]
    )


def map_from_reference_json(d: dict, feature_tracker, camera=None) -> Map:
    """Parse a reference-schema map.json (the wrapper or the bare map body)
    into the port's SoA Map on ``feature_tracker.device``."""
    body = d.get("map", d)
    bits = desc_bits(feature_tracker)
    m = Map(device=feature_tracker.device)
    st = m.points

    # ---- points ----------------------------------------------------------
    pts = body.get("points", [])
    if pts:
        needed = max(int(p["id"]) for p in pts) + 1
        while st.capacity < needed:
            st._grow()
        st.size = max(st.size, needed)
        for p in pts:
            pid = int(p["id"])
            st.pos[pid] = np.asarray(_maybe_json_list(p["pt"]), float)
            des = _des_in(p.get("des"), bits)
            if des is not None:
                des = des.reshape(1, -1) if des.ndim == 1 else des
                st.ensure_desc_layout(des)
                st.desc[pid] = des[0]
            if p.get("normal") is not None:
                st.normal[pid] = np.asarray(p["normal"], float)
            st.min_dist[pid] = float(p.get("_min_distance") or 0.0)
            st.max_dist[pid] = float(p.get("_max_distance") or np.inf)
            st.n_visible[pid] = int(p.get("num_times_visible") or 1)
            st.n_found[pid] = int(p.get("num_times_found") or 1)
            st.first_kid[pid] = int(p.get("first_kid") or 0)
            st.valid[pid] = not p.get("_is_bad", False)

    # ---- keyframes -------------------------------------------------------
    fid_to_kid: dict[int, int] = {}
    links: dict[int, tuple] = {}
    max_kid = max_fid = -1
    for kfd in body.get("keyframes", []):
        if kfd.get("_is_bad"):
            continue
        cam = (
            camera_from_reference_json(kfd["camera"])
            if camera is None and kfd.get("camera") else camera
        )
        f = Frame(cam, feature_tracker=feature_tracker, frame_id=int(kfd["id"]),
                  timestamp=float(kfd.get("timestamp") or 0.0))
        f.Tcw = np.asarray(kfd["pose"], np.float64).reshape(4, 4)
        kps = np.asarray(_maybe_json_list(kfd["kps"]), np.float32)
        n = len(kps)

        def field(name, default, dtype):
            v = kfd.get(name)
            return np.asarray(_maybe_json_list(v) if v is not None else default, dtype)

        f.set_host_fields(
            kps=kps, levels=field("octaves", np.zeros(n), np.int32),
            angles=field("angles", np.zeros(n), np.float32),
            sizes=field("sizes", np.zeros(n), np.float32), valid=np.ones(n, bool),
            kps_ur=field("kps_ur", np.full(n, -1.0), np.float32),
            depths=field("depths", np.full(n, -1.0), np.float32))
        f.des = _des_in(kfd.get("des"), bits)
        pts_slots = kfd.get("points")
        if pts_slots is not None:
            f.points = np.asarray(pts_slots, np.int64)
        out = kfd.get("outliers")
        if out is not None:
            f.outliers = np.asarray(out, bool)
        kf = KeyFrame(f, kid=int(kfd["kid"]))
        kf.is_bad = bool(kfd.get("_is_bad", False))
        kf.lba_count = int(kfd.get("lba_count") or 0)
        kf.not_to_erase = bool(kfd.get("not_to_erase", False))
        links[kf.kid] = (kfd.get("parent"), kfd.get("children") or [],
                         kfd.get("loop_edges") or [],
                         kfd.get("connected_keyframes_weights") or [])
        fid_to_kid[kf.id] = kf.kid
        m.add_keyframe(kf)
        max_kid = max(max_kid, kf.kid)
        max_fid = max(max_fid, kf.id)

    # graph links: frame ids -> kids
    for kid in m.keyframe_order:
        kf = m.keyframes[kid]
        parent, children, loops, conn = links[kid]
        kf.parent = fid_to_kid.get(parent)
        kf.children = {fid_to_kid[f] for f in children if f in fid_to_kid}
        kf.loop_edges = {fid_to_kid[f] for f in loops if f in fid_to_kid}
        kf.connected_keyframes = {fid_to_kid[f]: int(w) for f, w in conn if f in fid_to_kid}
        kf._reorder()
        # observations from keyframe slots (authoritative, like the native
        # loader)
        m.restore_observations(kf)
    for pid, obs in m.observations.items():
        st.num_obs[pid] = len(obs)

    m.max_frame_id = max(m.max_frame_id, max_fid)
    m.max_keyframe_id = max(m.max_keyframe_id, max_kid)
    Frame._id_counter = max(Frame._id_counter, max_fid + 1)
    return m


def _maybe_json_list(v):
    if isinstance(v, str):
        import json as _json

        return _json.loads(v)
    if isinstance(v, dict):
        return _any_array(v)
    return v
