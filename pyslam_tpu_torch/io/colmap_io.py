"""COLMAP sparse-model I/O (text + binary) and SLAM-map export (port of
``pyslam_tpu/io/colmap_io.py``: the same numpy and ``struct`` code).

Reference surface: pySLAM ``pyslam/io/colmap_io.py`` (``read_images_binary``
/ ``read_images_text`` / ``colmap_qvec_tvec_to_Twc`` /
``resolve_colmap_sparse_path``, used to load CLIO ground-truth poses).
This module covers the same readers plus full model read/write (cameras,
images, points3D, both formats) and an exporter from the port's ``Map``
and camera (``map_to_colmap``), so SLAM results can be consumed by
COLMAP-based tooling.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (w, x, y, z) world->cam rotation
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


@dataclass
class ColmapPoint3D:
    point3D_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


_CAMERA_MODELS = {0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
                  2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
                  4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
                  6: ("FULL_OPENCV", 12), 7: ("FOV", 5),
                  8: ("SIMPLE_RADIAL_FISHEYE", 4),
                  9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12)}
_MODEL_IDS = {name: (mid, n) for mid, (name, n) in _CAMERA_MODELS.items()}


def qvec_to_R(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def R_to_qvec(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[i + 1] = 0.25 * s
    q[j + 1] = (R[j, i] + R[i, j]) / s
    q[k + 1] = (R[k, i] + R[i, k]) / s
    return q


def colmap_qvec_tvec_to_Twc(qvec, tvec) -> np.ndarray:
    """COLMAP stores world->cam; return the cam->world 4x4 (reference
    ``colmap_io.py:111``)."""
    R = qvec_to_R(np.asarray(qvec, float))
    t = np.asarray(tvec, float)
    T = np.eye(4)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ t
    return T


# ----------------------------------------------------------------- readers
def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            out[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array(el[4:], float))
    return out


def read_images_text(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        img = ColmapImage(int(el[0]), np.array(el[1:5], float),
                          np.array(el[5:8], float), int(el[8]),
                          " ".join(el[9:]))
        if i + 1 < len(lines):
            el2 = lines[i + 1].split()
            if el2:
                arr = np.array(el2, float).reshape(-1, 3)
                img.xys = arr[:, :2]
                img.point3D_ids = arr[:, 2].astype(np.int64)
        out[img.image_id] = img
    return out


def read_points3D_text(path: str) -> dict[int, ColmapPoint3D]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            tracks = np.array(el[8:], float).reshape(-1, 2) \
                if len(el) > 8 else np.zeros((0, 2))
            out[int(el[0])] = ColmapPoint3D(
                int(el[0]), np.array(el[1:4], float),
                np.array(el[4:7], float).astype(np.uint8), float(el[7]),
                tracks[:, 0].astype(np.int64),
                tracks[:, 1].astype(np.int64))
    return out


def _read_bytes(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read_bytes(f, 8, "Q")
        for _ in range(n):
            cid, mid, w, h = _read_bytes(f, 24, "iiQQ")
            name, np_ = _CAMERA_MODELS[mid]
            params = np.array(_read_bytes(f, 8 * np_, "d" * np_))
            out[cid] = ColmapCamera(cid, name, w, h, params)
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read_bytes(f, 8, "Q")
        for _ in range(n):
            vals = _read_bytes(f, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read_bytes(f, 8, "Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=[("x", "<f8"), ("y", "<f8"),
                                        ("id", "<i8")])
            img = ColmapImage(image_id, qvec, tvec, camera_id,
                              name.decode("utf-8"))
            img.xys = np.stack([data["x"], data["y"]], -1) \
                if npts else np.zeros((0, 2))
            img.point3D_ids = data["id"].copy() if npts \
                else np.zeros(0, np.int64)
            out[image_id] = img
    return out


def read_points3D_binary(path: str) -> dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read_bytes(f, 8, "Q")
        for _ in range(n):
            vals = _read_bytes(f, 43, "QdddBBBd")
            (tlen,) = _read_bytes(f, 8, "Q")
            track = np.frombuffer(f.read(8 * tlen),
                                  dtype=[("img", "<i4"), ("p2d", "<i4")])
            out[vals[0]] = ColmapPoint3D(
                vals[0], np.array(vals[1:4]),
                np.array(vals[4:7], np.uint8), vals[7],
                track["img"].astype(np.int64).copy(),
                track["p2d"].astype(np.int64).copy())
    return out


def read_model(sparse_dir: str):
    """-> (cameras, images, points3d); auto-detects text vs binary."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        return (read_cameras_binary(os.path.join(sparse_dir, "cameras.bin")),
                read_images_binary(os.path.join(sparse_dir, "images.bin")),
                read_points3D_binary(os.path.join(sparse_dir, "points3D.bin")))
    return (read_cameras_text(os.path.join(sparse_dir, "cameras.txt")),
            read_images_text(os.path.join(sparse_dir, "images.txt")),
            read_points3D_text(os.path.join(sparse_dir, "points3D.txt")))


def resolve_colmap_sparse_path(base_path: str) -> str:
    """Find a sparse model folder under base_path (reference
    ``colmap_io.py:198``): tries sparse/0, sparse, colmap/sparse/0, …"""
    for cand in ("sparse/0", "sparse", "colmap/sparse/0", "colmap/sparse",
                 "."):
        p = os.path.join(base_path, cand)
        if (os.path.exists(os.path.join(p, "images.txt"))
                or os.path.exists(os.path.join(p, "images.bin"))):
            return p
    raise FileNotFoundError(f"no COLMAP sparse model under {base_path}")


# ----------------------------------------------------------------- writers
def write_model_text(cameras: dict, images: dict, points3d: dict,
                     out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for c in cameras.values():
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} "
                    + " ".join(f"{p:.10g}" for p in c.params) + "\n")
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID "
                "NAME\n#   POINTS2D[] as (X Y POINT3D_ID)\n")
        for im in images.values():
            f.write(f"{im.image_id} "
                    + " ".join(f"{v:.10g}" for v in im.qvec) + " "
                    + " ".join(f"{v:.10g}" for v in im.tvec)
                    + f" {im.camera_id} {im.name}\n")
            f.write(" ".join(
                f"{x:.4f} {y:.4f} {pid}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)) + "\n")
    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR "
                "TRACK[] as (IMAGE_ID POINT2D_IDX)\n")
        for p in points3d.values():
            f.write(f"{p.point3D_id} "
                    + " ".join(f"{v:.10g}" for v in p.xyz) + " "
                    + " ".join(str(int(v)) for v in p.rgb)
                    + f" {p.error:.6g} "
                    + " ".join(f"{i} {j}" for i, j in
                               zip(p.image_ids, p.point2D_idxs)) + "\n")


def map_to_colmap(slam_map, camera, out_dir: str):
    """Export our sparse SLAM map (slam/map.py Map) as a COLMAP text model."""
    cam = ColmapCamera(1, "PINHOLE", camera.width, camera.height,
                       np.array([camera.fx, camera.fy, camera.cx,
                                 camera.cy]))
    images, points = {}, {}
    pid_rows = {}
    st = slam_map.points
    for pid in map(int, st.alive_ids()):
        points[pid + 1] = ColmapPoint3D(
            pid + 1, st.pos[pid].astype(float),
            np.array([128, 128, 128], np.uint8), 1.0,
            np.zeros(0, np.int64), np.zeros(0, np.int64))
        pid_rows[pid] = pid + 1
    for kid in slam_map.keyframe_order:
        kf = slam_map.keyframes[kid]
        Tcw = np.asarray(kf.Tcw, float)
        q = R_to_qvec(Tcw[:3, :3])
        img = ColmapImage(kid + 1, q, Tcw[:3, 3], 1, f"frame_{kf.id:06d}.png")
        obs_xy, obs_pid, tracks = [], [], []
        for ki, pid in enumerate(np.asarray(kf.points)):
            if pid >= 0 and int(pid) in pid_rows:
                obs_xy.append(kf.kps[ki])
                obs_pid.append(pid_rows[int(pid)])
        img.xys = np.asarray(obs_xy, float).reshape(-1, 2)
        img.point3D_ids = np.asarray(obs_pid, np.int64)
        images[kid + 1] = img
        for local_idx, cpid in enumerate(img.point3D_ids):
            p = points[int(cpid)]
            p.image_ids = np.append(p.image_ids, kid + 1)
            p.point2D_idxs = np.append(p.point2D_idxs, local_idx)
    write_model_text({1: cam}, images, points, out_dir)
    return out_dir
