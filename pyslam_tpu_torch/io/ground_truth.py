"""Ground-truth trajectory readers (host copy of
``pyslam_tpu/io/ground_truth.py``; reference: pySLAM ``io/ground_truth.py``).

Formats:
- KITTI: one ``r11 r12 r13 tx r21 ... tz`` 3x4 row-major pose per line
  (camera-to-world), timestamps in a separate ``times.txt``.
- TUM: ``timestamp tx ty tz qx qy qz qw`` per line.
- EuRoC: ``state_groundtruth_estimate0/data.csv`` ns-timestamped positions +
  quaternion (w, x, y, z order in the csv).
- ICL-NUIM, Replica, TartanAir, ScanNet, 7-Scenes and Neural-RGBD (below).

All readers produce (timestamps (T,), Twc (T,4,4)) in a GroundTruth object
supporting nearest-timestamp lookup.  Host numpy.
"""

from __future__ import annotations

import os

import numpy as np


def _quat_to_R(q):  # xyzw
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _R_to_quat(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, 0.25 * s]
        )
    i = np.argmax(np.diag(R))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[3] = (R[k, j] - R[j, k]) / s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    return q


class GroundTruth:
    def __init__(self, timestamps, Twc):
        self.timestamps = np.asarray(timestamps, float)
        self.Twc = np.asarray(Twc, float)

    @property
    def positions(self):
        return self.Twc[:, :3, 3]

    def __len__(self):
        return len(self.timestamps)

    def pose_at(self, t: float):
        """Nearest-timestamp pose (no interpolation — matches the evaluation
        association tolerance approach)."""
        i = int(np.argmin(np.abs(self.timestamps - t)))
        return self.Twc[i], self.timestamps[i]

    def trajectory_scale(self, i: int) -> float:
        """Per-frame GT displacement norm (used for mono scale in VO,
        reference ``visual_odometry_base.py:96``)."""
        if i <= 0 or i >= len(self):
            return 0.0
        return float(
            np.linalg.norm(self.Twc[i, :3, 3] - self.Twc[i - 1, :3, 3])
        )


def read_kitti_poses(pose_file: str, times_file: str | None = None) -> GroundTruth:
    data = np.loadtxt(pose_file).reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (len(data), 1, 1))
    T[:, :3, :] = data
    if times_file and os.path.exists(times_file):
        ts = np.loadtxt(times_file)
    else:
        ts = np.arange(len(data)) / 10.0
    return GroundTruth(ts, T)


def read_tum_trajectory(path: str) -> GroundTruth:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.replace(",", " ").split()])
    rows = np.asarray(rows)
    ts = rows[:, 0]
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, 3] = rows[:, 1:4]
    for i in range(len(rows)):
        T[i, :3, :3] = _quat_to_R(rows[i, 4:8])
    return GroundTruth(ts, T)


def read_euroc_csv(path: str) -> GroundTruth:
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            rows.append([float(x) for x in line.strip().split(",")[:8]])
    rows = np.asarray(rows)
    ts = rows[:, 0] * 1e-9
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, 3] = rows[:, 1:4]
    for i in range(len(rows)):
        w, x, y, z = rows[i, 4:8]
        T[i, :3, :3] = _quat_to_R([x, y, z, w])
    return GroundTruth(ts, T)


def read_icl_nuim_trajectory(path: str) -> GroundTruth:
    """ICL-NUIM groundtruth: TUM-format rows with the y axis inverted
    (reference ``ground_truth.py:782`` IclNuimGroundTruth)."""
    gt = read_tum_trajectory(path)
    T = gt.Twc.copy()
    T[:, 1, 3] *= -1.0
    flip = np.diag([1.0, -1.0, 1.0])
    for i in range(len(T)):
        T[i, :3, :3] = flip @ T[i, :3, :3] @ flip
    return GroundTruth(gt.timestamps, T)


def read_replica_trajectory(path: str, fps: float = 30.0) -> GroundTruth:
    """Replica ``traj.txt``: one row-major flattened 4x4 Twc per line,
    timestamps at a fixed camera rate (reference ReplicaGroundTruth)."""
    T = np.loadtxt(path).reshape(-1, 4, 4)
    ts = np.arange(len(T)) / fps
    return GroundTruth(ts, T)


def read_tartanair_trajectory(path: str, fps: float = 10.0) -> GroundTruth:
    """TartanAir ``pose_left.txt``: rows ``x y z qx qy qz qw`` (NED frame)
    at a fixed rate (reference TartanairGroundTruth)."""
    rows = np.loadtxt(path).reshape(-1, 7)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, 3] = rows[:, 0:3]
    for i in range(len(rows)):
        T[i, :3, :3] = _quat_to_R(rows[i, 3:7])
    return GroundTruth(np.arange(len(rows)) / fps, T)


def read_scannet_poses(pose_dir: str, fps: float = 30.0) -> GroundTruth:
    """ScanNet ``pose/<n>.txt``: one 4x4 Twc per frame file, ordered by the
    integer frame id in the filename (reference ScannetGroundTruth)."""
    import glob

    files = glob.glob(os.path.join(pose_dir, "*.txt"))
    files.sort(key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))
    T = np.stack([np.loadtxt(f).reshape(4, 4) for f in files])
    ok = np.isfinite(T).all(axis=(1, 2))   # ScanNet has -inf dropout poses
    return GroundTruth(np.arange(len(T))[ok] / fps, T[ok])


def read_seven_scenes_poses(seq_dir: str, fps: float = 30.0) -> GroundTruth:
    """7-Scenes ``frame-XXXXXX.pose.txt``: one 4x4 Twc per frame in a
    ``seq-XX`` folder (reference SevenScenesGroundTruth)."""
    import glob

    files = sorted(glob.glob(os.path.join(seq_dir, "frame-*.pose.txt")))
    if not files:
        seqs = sorted(glob.glob(os.path.join(seq_dir, "seq-*")))
        if seqs:
            files = sorted(
                glob.glob(os.path.join(seqs[0], "frame-*.pose.txt"))
            )
    T = np.stack([np.loadtxt(f).reshape(4, 4) for f in files])
    return GroundTruth(np.arange(len(T)) / fps, T)


def read_neural_rgbd_poses(path: str, fps: float = 30.0) -> GroundTruth:
    """Neural-RGBD ``poses.txt`` / ``trainval_poses.txt``: N stacked 4x4
    matrices (4N lines of 4 floats); non-finite poses are dropped
    (reference NeuralRGBDGroundTruth)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                vals = [float(x) for x in line.split()]
            except ValueError:
                vals = [np.nan] * 4
            rows.append((vals + [0.0] * 4)[:4])
    T = np.asarray(rows, np.float64).reshape(-1, 4, 4)
    ok = np.isfinite(T).all(axis=(1, 2))
    return GroundTruth(np.arange(len(T))[ok] / fps, T[ok])


def groundtruth_factory(settings: dict) -> GroundTruth | None:
    """Dispatch on ``type`` like the reference's groundtruth_factory
    (reference ``ground_truth.py:75``; full reader coverage: KITTI / TUM /
    EuRoC / ICL-NUIM / Replica / TartanAir / ScanNet / 7-Scenes /
    Neural-RGBD / simple / synthetic)."""
    gt_type = settings.get("type", None)
    if gt_type in (None, "none"):
        return None
    fps_kw = (
        {"fps": settings["fps"]} if "fps" in settings else {}
    )
    if gt_type == "kitti":
        return read_kitti_poses(settings["path"], settings.get("times_path"))
    if gt_type in ("tum", "simple"):
        return read_tum_trajectory(settings["path"])
    if gt_type == "euroc":
        return read_euroc_csv(settings["path"])
    if gt_type == "icl_nuim":
        return read_icl_nuim_trajectory(settings["path"])
    if gt_type == "replica":
        return read_replica_trajectory(settings["path"], **fps_kw)
    if gt_type == "tartanair":
        return read_tartanair_trajectory(settings["path"], **fps_kw)
    if gt_type == "scannet":
        return read_scannet_poses(settings["path"], **fps_kw)
    if gt_type == "seven_scenes":
        return read_seven_scenes_poses(settings["path"], **fps_kw)
    if gt_type == "neural_rgbd":
        return read_neural_rgbd_poses(settings["path"], **fps_kw)
    if gt_type == "synthetic":
        ds = settings["dataset"]
        return GroundTruth(
            np.array([ds.getTimestamp(i) for i in range(len(ds))]), ds.poses
        )
    raise ValueError(f"unknown groundtruth type {gt_type}")
