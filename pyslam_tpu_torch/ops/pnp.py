"""Batched-hypothesis RANSAC Perspective-n-Point for relocalisation (port of
``pyslam_tpu/ops/pnp.py:23-123``).

K minimal samples of 6 2D-3D correspondences are solved as one batch with
the linear DLT (12-parameter projection matrix from the eigenvector of the
smallest eigenvalue, in float64, projected onto SE(3)), scored on every
point at once,
and the best (first of the highest inlier count) is polished by 8
Gauss-Newton iterations on its inliers.  ``samples`` (K, 6) replaces the
random draw.
"""

from __future__ import annotations

import torch

from pyslam_tpu_torch.ops import lie
from pyslam_tpu_torch.ops.epipolar import _sample_minimal


def _dlt_pnp(pts3d: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Linear PnP on (..., n, 3) points and (..., n, 2) normalised
    coordinates; returns (..., 4, 4) world->camera transforms in the
    inputs' type.  The 12x12 eigen-solve runs in float64: the card's
    batched float32 solver keeps 2.6x fewer usable hypotheses than float64
    on points 4-70 m away (``tests/torch_pnp_conditioning.py``), which made
    relocalisation on the card miss frames the CPU relocalised."""
    dtype = pts3d.dtype
    pts3d, xy = pts3d.double(), xy.double()
    X = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], -1)           # (..., n, 4)
    zeros = torch.zeros_like(X)
    x, y = xy[..., 0:1], xy[..., 1:2]
    A = torch.cat([torch.cat([X, zeros, -x * X], -1),
                   torch.cat([zeros, X, -y * X], -1)], -2)               # (..., 2n, 12)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 4)
    sign = torch.where(lie.det3(P[..., :3]) < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    scale = lie._cbrt(torch.clamp(lie.det3(P[..., :3]), min=1e-12))
    R = lie.project_to_SO3(P[..., :3] / scale[..., None, None])
    return lie.rt_to_T(R, P[..., 3] / scale[..., None]).to(dtype)


def _reproj_err2(Tcw: torch.Tensor, pts3d: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    pc = lie.transform_points(Tcw, pts3d)
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    e2 = torch.sum((pc[..., :2] / zs[..., None] - xy) ** 2, -1)
    return torch.where(z > 0, e2, torch.full_like(e2, 1e12))   # behind the camera


def _gauss_newton_pose(Tcw, pts3d, xy, weights, iters: int = 8):
    """Weighted Gauss-Newton refinement of one pose on the reprojection in
    normalised coordinates (left-multiplied twist increments)."""
    eye6 = 1e-6 * torch.eye(6, dtype=Tcw.dtype, device=Tcw.device)
    T = Tcw
    for _ in range(iters):
        pc = lie.transform_points(T, pts3d)
        z = torch.clamp(pc[..., 2], min=1e-6)
        proj = pc[..., :2] / z[..., None]
        x, y = pc[..., 0], pc[..., 1]
        iz = 1.0 / z
        iz2 = iz * iz
        zero = torch.zeros_like(iz)
        J = torch.stack([
            torch.stack([iz, zero, -x * iz2, -x * y * iz2, 1.0 + x * x * iz2, -y * iz], -1),
            torch.stack([zero, iz, -y * iz2, -(1.0 + y * y * iz2), x * y * iz2, x * iz], -1),
        ], -2)                                                            # (N, 2, 6)
        Jw = J * weights[..., None, None]
        H = torch.einsum("nij,nik->jk", Jw, J) + eye6
        g = torch.einsum("nij,ni->j", Jw, proj - xy)
        dx = -torch.linalg.solve_ex(H, g)[0]
        T = lie.se3_exp(dx) @ T
    return T


def solve_pnp_ransac(pts3d: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
                     threshold2: float, num_hyp: int = 256, *,
                     generator: torch.Generator | None = None,
                     samples: torch.Tensor | None = None):
    """RANSAC PnP on (N, 3) world points and (N, 2) normalised coordinates;
    ``threshold2`` is the squared inlier threshold in normalised units.
    Returns (Tcw (4, 4), inlier mask, number of inliers)."""
    if samples is None:
        samples = _sample_minimal(valid, num_hyp, 6, generator=generator)
    samples = samples.to(device=valid.device, dtype=torch.int64)
    Ts = _dlt_pnp(pts3d[samples], xy[samples])                         # (K, 4, 4)
    inl = (_reproj_err2(Ts, pts3d, xy) < threshold2) & valid[None, :]
    best = torch.argmax(torch.sum(inl, 1))
    T_best = Ts[best]
    mask = inl[best]
    T_ref = _gauss_newton_pose(T_best, pts3d, xy, mask.to(xy.dtype))
    mask_ref = (_reproj_err2(T_ref, pts3d, xy) < threshold2) & valid
    use_ref = torch.sum(mask_ref) >= torch.sum(mask)
    T_out = torch.where(use_ref, T_ref, T_best)
    mask_out = torch.where(use_ref, mask_ref, mask)
    return T_out, mask_out, torch.sum(mask_out)
