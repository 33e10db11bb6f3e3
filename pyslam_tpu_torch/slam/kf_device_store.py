"""Stacked device store of keyframe extractions for the back-end matchers
(port of ``pyslam_tpu/slam/kf_device_store.py``).

One set of (B, N, ...) device tensors holds the extraction payload (kps,
levels, des, valid, kps_ur) of the B most recently used keyframes; the
triangulation and fuse matchers gather their neighbour keyframes from it by
row, so a back-end call ships only row indices and small masks.  A row is
written once per keyframe, IN PLACE, from the keyframe's own device
tensors; the payload is immutable after extraction, so rows never need a
refresh.  The descriptor block takes the session's layout (dim, dtype):
int8 bits or float32.
"""

from __future__ import annotations

import numpy as np
import torch


class KFDeviceStore:
    """LRU ring of per-keyframe extraction payloads on ``device``."""

    def __init__(self, num_rows: int, num_kps: int, desc_dim: int,
                 device: torch.device, desc_dtype=torch.int8):
        self.B = int(num_rows)
        self.N = int(num_kps)
        self.D = int(desc_dim)
        self.kps = torch.zeros((self.B, self.N, 2), dtype=torch.float32, device=device)
        self.levels = torch.zeros((self.B, self.N), dtype=torch.int64, device=device)
        self.des = torch.zeros((self.B, self.N, self.D), dtype=desc_dtype, device=device)
        self.valid = torch.zeros((self.B, self.N), dtype=torch.bool, device=device)
        self.kps_ur = torch.full((self.B, self.N), -1.0, dtype=torch.float32, device=device)
        self._row_of: dict[int, int] = {}   # kid -> row (insertion order = LRU)

    def invalidate(self, kid: int):
        self._row_of.pop(kid, None)

    def _write(self, kf, row: int):
        self.kps[row] = kf.dev("kps")
        self.levels[row] = kf.dev("levels")
        self.des[row] = kf.dev("des")
        self.valid[row] = kf.dev("valid")
        self.kps_ur[row] = kf.dev("kps_ur")

    def rows_for(self, kfs) -> np.ndarray:
        """Make every keyframe resident; return their rows.  A miss takes the
        least recently used row not needed by this call (len(kfs) <= B)."""
        need = []
        for kf in kfs:
            if kf.kid in self._row_of:
                self._row_of[kf.kid] = self._row_of.pop(kf.kid)
            else:
                need.append(kf)
        if need:
            wanted = {kf.kid for kf in kfs}
            used = set(self._row_of.values())
            free = [r for r in range(self.B) if r not in used]
            for kf in need:
                if free:
                    row = free.pop()
                else:
                    victim = next(k for k in self._row_of if k not in wanted)
                    row = self._row_of.pop(victim)
                self._write(kf, row)
                self._row_of[kf.kid] = row
        return np.asarray([self._row_of[kf.kid] for kf in kfs], np.int64)
