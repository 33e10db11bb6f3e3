"""Two-view geometry on the host: DLT triangulation, the fundamental matrix
and the triangulation checks (the ``*_np`` helpers of
``pyslam_tpu/ops/geometry.py``, copied: the local-mapping path triangulates
and checks its small batches on the host in float64).  Projection on the
device lives with its callers (``ops/slam_matching.py``, ``ops/optim.py``).
"""

from __future__ import annotations

import numpy as np


def triangulate_dlt_np(T1w, T2w, xy1, xy2) -> "np.ndarray":
    """Float64 HOST twin of ``triangulate_dlt``.

    On the TPU backend a ``jnp.float64`` request silently truncates to f32,
    and the DLT eigensolve is precision-sensitive — f32 triangulation noise
    measurably inflates trajectory drift.  Map-point creation is a small
    batch on the local-mapping path, so the f64 eigensolve runs on host.
    """
    T1w = np.asarray(T1w, np.float64)
    T2w = np.asarray(T2w, np.float64)
    xy1 = np.asarray(xy1, np.float64)
    xy2 = np.asarray(xy2, np.float64)
    P1, P2 = T1w[:3, :], T2w[:3, :]

    def rows(P, xy):
        r0 = xy[..., 0:1] * P[2][None, :] - P[0][None, :]
        r1 = xy[..., 1:2] * P[2][None, :] - P[1][None, :]
        return r0, r1

    a0, a1 = rows(P1, xy1)
    a2, a3 = rows(P2, xy2)
    A = np.stack([a0, a1, a2, a3], axis=-2)
    AtA = np.einsum("nij,nik->njk", A, A)
    _, vecs = np.linalg.eigh(AtA)
    h = vecs[..., 0]
    w = h[..., 3]
    ws = np.where(np.abs(w) < 1e-12, 1e-12, w)
    return h[..., :3] / ws[..., None]


def fundamental_np(T_21, K1, K2):
    """Host-numpy fundamental matrix F_21 (x2^T F x1 = 0) from cam1->cam2.

    3x3 outputs are cheaper to compute on host than to read back from the
    device (one RTT per covisible neighbor in the triangulation loop).
    """
    R, t = np.asarray(T_21)[:3, :3], np.asarray(T_21)[:3, 3]
    E = np.array(
        [[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]]
    ) @ R
    return np.linalg.inv(np.asarray(K2)).T @ E @ np.linalg.inv(np.asarray(K1))


def triangulation_checks_np(
    pts_w, T1w, T2w, xy1, xy2, sigma2_1, sigma2_2,
    chi2_th: float = 5.991, cos_max_parallax: float = 0.9998,
):
    """Host-numpy twin of :func:`triangulation_checks` (same gates, f64):
    the triangulated points already live on host (f64 DLT), so checking them
    on host removes a device round trip per covisible neighbor."""
    pts_w = np.asarray(pts_w, np.float64)
    T1w = np.asarray(T1w, np.float64)
    T2w = np.asarray(T2w, np.float64)
    pc1 = pts_w @ T1w[:3, :3].T + T1w[:3, 3]
    pc2 = pts_w @ T2w[:3, :3].T + T2w[:3, 3]
    z1, z2 = pc1[..., 2], pc2[..., 2]

    def reproj_err2(pc, xy):
        zs = np.where(np.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
        proj = pc[..., :2] / zs[..., None]
        return np.sum((proj - np.asarray(xy)) ** 2, axis=-1)

    e1 = reproj_err2(pc1, xy1)
    e2 = reproj_err2(pc2, xy2)
    c1 = -T1w[:3, :3].T @ T1w[:3, 3]
    c2 = -T2w[:3, :3].T @ T2w[:3, 3]
    r1 = pts_w - c1[None, :]
    r2 = pts_w - c2[None, :]
    cos_par = np.sum(r1 * r2, axis=-1) / np.maximum(
        np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1), 1e-12
    )
    return (
        (z1 > 0.0)
        & (z2 > 0.0)
        & (e1 < chi2_th * np.asarray(sigma2_1))
        & (e2 < chi2_th * np.asarray(sigma2_2))
        & (cos_par < cos_max_parallax)
    )
