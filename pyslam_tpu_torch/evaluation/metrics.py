"""Trajectory metrics: ATE (with Sim3/SE3 Umeyama alignment) and RPE.

Replaces the reference's dependency on the external ``evo`` package
(pySLAM ``pyslam/utilities/evaluation.py:22-135`` ``eval_ate``): association
by nearest timestamp, closed-form Umeyama alignment (optionally with scale for
monocular), RMSE/mean/median/max statistics, and relative-pose error over a
fixed frame delta.  Pure numpy — evaluation is host-side bookkeeping.

Host-only module, copied from ``pyslam_tpu/evaluation/metrics.py`` (the machine with the
card has no JAX, so the port cannot import the reference).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def associate_trajectories(t_est, t_gt, max_dt: float = 0.02):
    """Indices (est_idx, gt_idx) of nearest-timestamp pairs within max_dt."""
    t_est = np.asarray(t_est)
    t_gt = np.asarray(t_gt)
    gi = np.searchsorted(t_gt, t_est)
    pairs = []
    for i, g in enumerate(gi):
        best, best_dt = None, max_dt
        for j in (g - 1, g, g + 1):
            if 0 <= j < len(t_gt):
                dt = abs(t_gt[j] - t_est[i])
                if dt < best_dt:
                    best, best_dt = j, dt
        if best is not None:
            pairs.append((i, best))
    if not pairs:
        return np.zeros(0, int), np.zeros(0, int)
    a, b = zip(*pairs)
    return np.asarray(a), np.asarray(b)


def umeyama_np(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Closed-form alignment (numpy twin of ops.procrustes.umeyama)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = float(np.trace(np.diag(S) @ D) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


@dataclass
class ATEResult:
    rmse: float
    mean: float
    median: float
    std: float
    max: float
    num_pairs: int
    scale: float

    def __str__(self):
        return (
            f"ATE rmse={self.rmse:.4f} mean={self.mean:.4f} median={self.median:.4f} "
            f"max={self.max:.4f} (n={self.num_pairs}, s={self.scale:.3f})"
        )


def eval_ate(
    t_est,
    p_est,
    t_gt,
    p_gt,
    align: bool = True,
    with_scale: bool = False,
    max_dt: float = 0.02,
) -> ATEResult:
    """Absolute trajectory error between position sequences.

    p_est/p_gt: (N,3)/(M,3) positions; timestamps associate them.
    with_scale=True for monocular (Sim3 alignment), False for stereo/RGBD.
    """
    ia, ib = associate_trajectories(t_est, t_gt, max_dt)
    if len(ia) < 3:
        return ATEResult(np.inf, np.inf, np.inf, np.inf, np.inf, len(ia), 1.0)
    A = np.asarray(p_est)[ia]
    B = np.asarray(p_gt)[ib]
    # drop non-finite estimates (a diverged pose must degrade the metric via
    # n, not crash the SVD alignment)
    finite = np.isfinite(A).all(axis=1) & np.isfinite(B).all(axis=1)
    if finite.sum() < 3:
        return ATEResult(np.inf, np.inf, np.inf, np.inf, np.inf, int(finite.sum()), 1.0)
    A, B = A[finite], B[finite]
    if align:
        s, R, t = umeyama_np(A, B, with_scale)
        A = s * A @ R.T + t
    else:
        s = 1.0
    err = np.linalg.norm(A - B, axis=1)
    return ATEResult(
        rmse=float(np.sqrt((err ** 2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        std=float(err.std()),
        max=float(err.max()),
        num_pairs=len(err),
        scale=float(s),
    )


def eval_rpe(poses_est, poses_gt, delta: int = 1):
    """Relative pose error over frame delta; poses (N,4,4) aligned by index.

    Returns (trans_rmse, rot_rmse_deg).
    """
    poses_est = np.asarray(poses_est)
    poses_gt = np.asarray(poses_gt)
    n = min(len(poses_est), len(poses_gt)) - delta
    terr, rerr = [], []
    for i in range(n):
        de = np.linalg.inv(poses_est[i]) @ poses_est[i + delta]
        dg = np.linalg.inv(poses_gt[i]) @ poses_gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(c)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(
        np.sqrt(np.mean(np.square(rerr)))
    )
