"""Ground-truth trajectories (copy of ``GroundTruth`` and of the synthetic
branch of ``groundtruth_factory`` in ``pyslam_tpu/io/ground_truth.py``; the
dataset readers come with the dataset slice).  Host numpy."""

from __future__ import annotations

import numpy as np


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
        """Nearest-timestamp pose (no interpolation)."""
        i = int(np.argmin(np.abs(self.timestamps - t)))
        return self.Twc[i], self.timestamps[i]

    def trajectory_scale(self, i: int) -> float:
        """Ground-truth displacement from frame i - 1 to i (the monocular
        VO's scale)."""
        if i <= 0 or i >= len(self):
            return 0.0
        return float(np.linalg.norm(self.Twc[i, :3, 3] - self.Twc[i - 1, :3, 3]))


def groundtruth_factory(settings: dict) -> GroundTruth | None:
    """``{"type": "synthetic", "dataset": ds}`` -> the dataset's own poses;
    ``None`` or ``"none"`` -> None.  The file readers are not ported yet."""
    gt_type = settings.get("type", None)
    if gt_type in (None, "none"):
        return None
    if gt_type == "synthetic":
        ds = settings["dataset"]
        return GroundTruth(np.array([ds.getTimestamp(i) for i in range(len(ds))]), ds.poses)
    raise NotImplementedError(f"ground-truth reader not ported yet: {gt_type}")
