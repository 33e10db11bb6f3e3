"""Two-view geometry: lens distortion, DLT triangulation and the
triangulation checks on the device (port of ``pyslam_tpu/ops/geometry.py:41-204``),
and their ``*_np`` host twins with the fundamental matrix (the local-mapping
path triangulates and checks its small batches on the host in float64).
Projection on the device lives with its callers (``ops/slam_matching.py``,
``ops/optim.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.ops import lie


# ------------------------------------------------------------- distortion

def pixel_to_normalized(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> normalised image coordinates on the z = 1 plane."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], -1)


def distort_radtan(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Radial-tangential (OpenCV k1, k2, p1, p2, k3) distortion of
    normalised coordinates (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def _fma(a, b, c):
    """float32 fused multiply-add, emulated in float64: the product of two
    float32 values is exact there, and the add and the cast back are each
    correctly rounded on the CPU and the card (one rounding but where the
    float64 sum lands on a float32 midpoint)."""
    return (torch.as_tensor(a, dtype=torch.float64) * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).to(torch.float32)


def undistort_radtan(xy_d: torch.Tensor, dist: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert the rad-tan distortion by ``iters`` fixed-point iterations
    (OpenCV's scheme), starting from the distorted coordinates.

    The iteration rounds as the reference's compiled loop does on the CPU,
    where XLA contracts it into fused multiply-adds: r2 = fma(x, x, y*y),
    the radial polynomial as a Horner chain of FMAs, dx = fma(2p1*x, y,
    p2*fma(2x, x, r2)) and dy = fma(2p2*x, y, p1*fma(2y, y, r2)); bit-equal to
    it on 40,000 pixels of a TUM-like camera (a plain order leaves an ulp on
    ~1 % of them)."""
    k1, k2, p1, p2, k3 = (dist[i].to(torch.float32) for i in range(5))
    two, one = 2.0, torch.ones((), dtype=torch.float32, device=xy_d.device)
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = _fma(x, x, y * y)
        radial = _fma(r2, _fma(r2, _fma(r2, k3, k2), k1), one)
        dx = _fma((two * p1) * x, y, p2 * _fma(two * x, x, r2))
        dy = _fma((two * p2) * x, y, p1 * _fma(two * y, y, r2))
        xy = torch.stack([(xy_d[..., 0] - dx) / radial, (xy_d[..., 1] - dy) / radial], -1)
    return xy


def undistort_pixels(uv: torch.Tensor, K: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Distorted pixels (..., 2) -> undistorted pixels with the same K."""
    xy = undistort_radtan(pixel_to_normalized(uv, K), dist)
    return torch.stack([K[0, 0] * xy[..., 0] + K[0, 2], K[1, 1] * xy[..., 1] + K[1, 2]], -1)


# ---------------------------------------------------------- triangulation

def _dlt_rows(T1w, T2w, xy1, xy2):
    """(..., N, 4, 4) DLT systems of two views in normalised coordinates."""
    P1, P2 = T1w[..., :3, :], T2w[..., :3, :]

    def rows(P, xy):
        r0 = xy[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = xy[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return r0, r1

    a0, a1 = rows(P1, xy1)
    a2, a3 = rows(P2, xy2)
    return torch.stack([a0, a1, a2, a3], -2)


def triangulate_dlt(T1w: torch.Tensor, T2w: torch.Tensor, xy1: torch.Tensor,
                    xy2: torch.Tensor) -> torch.Tensor:
    """Two-view DLT triangulation in normalised coordinates: (N, 2) each
    -> (N, 3) world points, the eigenvector of the smallest eigenvalue of
    AᵀA.  ``T*w`` may carry leading batch dimensions (one per pose pair)."""
    A = _dlt_rows(T1w[..., None, :, :], T2w[..., None, :, :], xy1, xy2)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    h = vecs[..., 0]
    w = h[..., 3]
    ws = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return h[..., :3] / ws[..., None]


def triangulation_checks(pts_w, T1w, T2w, xy1, xy2, sigma2_1, sigma2_2,
                         chi2_th: float = 5.991, cos_max_parallax: float = 0.9998):
    """Acceptance mask (N,) of triangulated points: positive depth in both
    views, reprojection chi2 in normalised coordinates under ``chi2_th`` times
    each keypoint's sigma2 in both, and a parallax cosine under
    ``cos_max_parallax``."""
    pc1 = lie.transform_points(T1w, pts_w)
    pc2 = lie.transform_points(T2w, pts_w)

    def reproj_err2(pc, xy):
        z = pc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        return torch.sum((pc[..., :2] / zs[..., None] - xy) ** 2, -1)

    e1 = reproj_err2(pc1, xy1)
    e2 = reproj_err2(pc2, xy2)
    c1 = -T1w[:3, :3].T @ T1w[:3, 3]
    c2 = -T2w[:3, :3].T @ T2w[:3, 3]
    r1 = pts_w - c1[None, :]
    r2 = pts_w - c2[None, :]
    cos_par = torch.sum(r1 * r2, -1) / torch.clamp(
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=1e-12)
    return ((pc1[..., 2] > 0.0) & (pc2[..., 2] > 0.0) & (e1 < chi2_th * sigma2_1)
            & (e2 < chi2_th * sigma2_2) & (cos_par < cos_max_parallax))


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
