"""Trajectory writers: TUM / KITTI / EuRoC formats (host copy of
``pyslam_tpu/io/trajectory_writer.py``; reference: pySLAM
``io/trajectory_writer.py``).  The bytes are the JAX package's."""

from __future__ import annotations

import numpy as np

from pyslam_tpu_torch.io.ground_truth import _R_to_quat


class TrajectoryWriter:
    def __init__(self, format_type: str = "tum", filename: str = "trajectory.txt"):
        assert format_type in ("tum", "kitti", "euroc")
        self.format_type = format_type
        self.filename = filename
        self._fh = open(filename, "w")

    def write_pose(self, timestamp: float, Twc: np.ndarray):
        Twc = np.asarray(Twc)
        if self.format_type == "kitti":
            row = Twc[:3, :].reshape(-1)
            self._fh.write(" ".join(f"{v:.9f}" for v in row) + "\n")
        elif self.format_type == "tum":
            q = _R_to_quat(Twc[:3, :3])
            t = Twc[:3, 3]
            self._fh.write(
                f"{timestamp:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )
        else:  # euroc csv
            q = _R_to_quat(Twc[:3, :3])
            t = Twc[:3, 3]
            self._fh.write(
                f"{int(timestamp*1e9)},{t[0]:.9f},{t[1]:.9f},{t[2]:.9f},"
                f"{q[3]:.9f},{q[0]:.9f},{q[1]:.9f},{q[2]:.9f}\n"
            )

    def write_full_trajectory(self, timestamps, poses):
        for t, T in zip(timestamps, poses):
            self.write_pose(t, T)

    def close(self):
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
