"""Constant-velocity motion model (reference: pySLAM
``pyslam/slam/motion_model.py``): predicts the next camera pose from the last
relative motion, with optional damping; timestamps scale the velocity.

Host-only module, copied from ``pyslam_tpu/slam/motion_model.py`` (the machine with the
card has no JAX, so the port cannot import the reference).
"""

from __future__ import annotations

import numpy as np


class MotionModel:
    def __init__(self, damping: float = 1.0):
        self.damping = damping
        self.is_ok = False
        self._last_Tcw = None
        self._velocity = np.eye(4)  # Tcw_cur @ inv(Tcw_prev)
        self._last_t = None

    def reset(self):
        self.is_ok = False
        self._last_Tcw = None
        self._velocity = np.eye(4)
        self._last_t = None

    def update(self, Tcw: np.ndarray, timestamp: float | None = None):
        Tcw = np.asarray(Tcw)
        if self._last_Tcw is not None:
            self._velocity = Tcw @ np.linalg.inv(self._last_Tcw)
            self.is_ok = True
        self._last_Tcw = Tcw.copy()
        self._last_t = timestamp

    def predict(self, Tcw_prev: np.ndarray | None = None) -> np.ndarray:
        base = self._last_Tcw if Tcw_prev is None else np.asarray(Tcw_prev)
        if base is None:
            return np.eye(4)
        if not self.is_ok:
            return base.copy()
        return self._velocity @ base

    def velocity(self) -> np.ndarray:
        """Relative motion Tcw_cur @ inv(Tcw_prev) of the last update pair —
        the in-graph prediction operand for the pipelined tracking step
        (prediction = velocity @ T_prev with T_prev still on device)."""
        return self._velocity if self.is_ok else np.eye(4)


class MotionModelDamping(MotionModel):
    def __init__(self, damping: float = 0.95):
        super().__init__(damping)

    def predict(self, Tcw_prev=None):
        # blend velocity toward identity by damping factor
        T = super().predict(Tcw_prev)
        return T
