"""Adaptive descriptor-distance threshold via robust running stats.

Mirrors the reference's ``SLAMDynamicConfig`` (pySLAM
``pyslam/slam/slam_dynamic_config.py``): the projection-search descriptor
gate adapts to the actual distance distribution of accepted matches — median
+ k*MAD, exponentially smoothed, clamped to a sane range.  Scenes with
distinctive texture tighten the gate (fewer false matches); bland scenes
relax it (fewer dropped true matches).

Host-only module, copied from ``pyslam_tpu/slam/slam_dynamic_config.py`` (the machine with the
card has no JAX, so the port cannot import the reference).
"""

from __future__ import annotations

import numpy as np

from pyslam_tpu_torch.config_parameters import Parameters


class SLAMDynamicConfig:
    def __init__(
        self,
        initial_th: float | None = None,
        mad_k: float = 4.0,
        alpha: float = 0.3,
        min_th: float | None = None,
        max_th: float | None = None,
    ):
        base = (
            initial_th
            if initial_th is not None
            else Parameters.kMaxOrbDistanceSearchByReproj
        )
        self.descriptor_distance_th = float(base)
        self.mad_k = mad_k
        self.alpha = alpha
        # floor well above typical true-match distances: the stats come from
        # ACCEPTED matches (biased tight), so an unbounded adaptive gate
        # ratchets down until tracking starves — the reference clamps too
        self.min_th = min_th if min_th is not None else 0.65 * float(base)
        self.max_th = max_th if max_th is not None else 1.5 * float(base)

    def update_descriptor_stats(self, dists: np.ndarray) -> float:
        """Feed the descriptor distances of this frame's ACCEPTED matches."""
        dists = np.asarray(dists, np.float32)
        dists = dists[np.isfinite(dists)]
        if len(dists) < 10:
            return self.descriptor_distance_th
        med = float(np.median(dists))
        mad = float(np.median(np.abs(dists - med))) * 1.4826  # -> sigma
        target = np.clip(med + self.mad_k * mad, self.min_th, self.max_th)
        self.descriptor_distance_th = float(
            (1 - self.alpha) * self.descriptor_distance_th + self.alpha * target
        )
        return self.descriptor_distance_th


def hamming_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise Hamming distance between paired unpacked-bit descriptors."""
    return np.abs(a.astype(np.int16) - b.astype(np.int16)).sum(axis=1)
