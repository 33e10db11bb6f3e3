"""Levenberg-Marquardt pose optimisation and bundle adjustment with an exact
Schur complement (port of ``pyslam_tpu/ops/optim.py:36-446``; Sim(3) and
pose-graph optimisation come with the loop-closing slice).

- Observations are flat arrays ``(cam_idx, pt_idx, uv, ur, sigma2, valid)``;
  invalid slots carry zero weight.
- Jacobians are the analytic 3x6 / 3x3 blocks, built for all observations at
  once; Huber weights with per-octave information.
- Landmarks are eliminated exactly; the reduced (6C, 6C) camera system is
  solved densely after Jacobi equilibration.
- Accept/reject decisions stay on the device (``torch.where``), so a run of
  LM iterations needs no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pyslam_tpu_torch.ops import lie


class BAProblem(NamedTuple):
    """Bundle-adjustment problem.

    poses (C, 4, 4) world->camera; points (P, 3); cam_idx, pt_idx (O,)
    int64; uv (O, 2); ur (O,) right-image u, < 0 for mono; sigma2 (O,);
    valid (O,) bool; fixed (C,) bool; K (3, 3); bf () baseline * fx.
    """

    poses: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    ur: torch.Tensor
    sigma2: torch.Tensor
    valid: torch.Tensor
    fixed: torch.Tensor
    K: torch.Tensor
    bf: torch.Tensor


CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _residual_jacobians(poses, points, uv, ur, K, bf):
    """Per observation: residual (O, 3) [u, v, u_r], Jc (O, 3, 6),
    Jp (O, 3, 3), behind (O,), is_stereo (O,).  Stereo rows are zero for
    mono observations (ur < 0)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    R = poses[..., :3, :3]
    pc = (R @ points[..., None])[..., 0] + poses[..., :3, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    iz = torch.ones_like(z_safe) / z_safe
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    u_r = u - bf * iz
    is_stereo = ur >= 0.0
    zero = torch.zeros_like(iz)
    r = torch.stack([u - uv[..., 0], v - uv[..., 1],
                     torch.where(is_stereo, u_r - ur, zero)], -1)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    dpc = torch.cat([eye, -lie.hat(pc)], -1)                       # (O, 3, 6)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], -1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], -1)
    dur = du + torch.stack([zero, zero, bf * iz2], -1)
    dproj = torch.stack([du, dv, torch.where(is_stereo[..., None], dur,
                                             torch.zeros_like(dur))], -2)
    Jc = dproj @ dpc
    Jp = dproj @ R
    return r, Jc, Jp, z < 1e-6, is_stereo


def _robust_weights(r, sigma2, is_stereo, use_robust: bool = True):
    """(information * Huber weight, raw chi2, robust loss) per observation."""
    info = 1.0 / torch.clamp(sigma2, min=1e-12)
    chi2 = torch.sum(r * r, -1) * info
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(chi2.dtype)
    if use_robust:
        rn = torch.sqrt(torch.clamp(chi2, min=1e-18))
        delta = torch.sqrt(delta2)
        w_rob = torch.clamp(delta / rn, max=1.0)
        loss = torch.where(chi2 <= delta2, chi2, 2.0 * delta * rn - delta2)
    else:
        w_rob = torch.ones_like(chi2)
        loss = chi2
    return info * w_rob, chi2, loss


def ba_cost_and_chi2(problem: BAProblem, use_robust: bool = True):
    r, _, _, behind, is_stereo = _residual_jacobians(
        problem.poses[problem.cam_idx], problem.points[problem.pt_idx], problem.uv,
        problem.ur, problem.K, problem.bf)
    _, chi2, loss = _robust_weights(r, problem.sigma2, is_stereo, use_robust)
    active = problem.valid & ~behind
    cost = torch.sum(torch.where(active, loss, torch.zeros_like(loss)))
    return cost, chi2, active


def ba_outlier_mask(problem: BAProblem) -> torch.Tensor:
    """Post-BA chi2 inlier classification of the observations."""
    _, chi2, active = ba_cost_and_chi2(problem, use_robust=False)
    delta2 = torch.where(problem.ur >= 0.0, CHI2_STEREO, CHI2_MONO).to(chi2.dtype)
    return active & (chi2 <= delta2)


# ----------------------------------------------------------------- frontend

def pose_optimization(Tcw, pts3d, uv, ur, sigma2, valid, K, bf,
                      rounds: int = 4, iters_per_round: int = 10):
    """Motion-only BA: one camera pose against fixed 3-D points.

    ``rounds`` rounds of ``iters_per_round`` LM iterations; at every round
    boundary each observation is re-classified inlier/outlier by its raw
    chi2.  One residual evaluation per iteration (deferred acceptance: the
    cost at the candidate pose scores the previous step and builds the
    next one).  Returns (Tcw_opt, inlier mask, number of inliers), all
    tensors on the input's device."""
    bf = torch.as_tensor(bf, dtype=Tcw.dtype, device=Tcw.device)
    delta2 = torch.where(ur >= 0.0, CHI2_STEREO, CHI2_MONO).to(Tcw.dtype)
    n = pts3d.shape[0]

    def residuals(T, inliers, use_robust=True):
        r, Jc, _, behind, is_st = _residual_jacobians(T.expand(n, 4, 4), pts3d, uv, ur, K, bf)
        w, chi2, loss = _robust_weights(r, sigma2, is_st, use_robust)
        active = inliers & ~behind
        w = torch.where(active, w, torch.zeros_like(w))
        return r, Jc, w, chi2, loss, active, behind

    def cost_of(T, inliers):
        _, _, _, _, loss, active, _ = residuals(T, inliers)
        return torch.sum(torch.where(active, loss, torch.zeros_like(loss)))

    T_cand = Tcw
    T_best = Tcw
    lam = torch.tensor(1e-4, dtype=Tcw.dtype, device=Tcw.device)
    best_cost = torch.tensor(1e30, dtype=Tcw.dtype, device=Tcw.device)
    inliers = valid
    for i in range(rounds * iters_per_round):
        r, Jc, w, _, loss, active, _ = residuals(T_cand, inliers)
        cand_cost = torch.sum(torch.where(active, loss, torch.zeros_like(loss)))
        accept = cand_cost < best_cost
        T_base = torch.where(accept, T_cand, T_best)
        best_cost = torch.where(accept, cand_cost, best_cost)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        Jw = Jc * w[:, None, None]
        H = torch.einsum("nij,nik->jk", Jw, Jc)
        g = torch.einsum("nij,ni->j", Jw, r)
        D = torch.diag(torch.clamp(torch.diagonal(H), min=1e-6))
        dx = -torch.linalg.solve_ex(H + lam * D, g)[0]
        T_cand = lie.se3_exp(dx) @ T_base
        T_best = T_base
        if (i + 1) % iters_per_round == 0:
            _, _, _, chi2, _, _, behind = residuals(T_best, valid, use_robust=False)
            inliers = valid & ~behind & (chi2 <= delta2)
            T_cand = T_best
            best_cost = cost_of(T_best, inliers)
    return T_best, inliers, torch.sum(inliers)


# -------------------------------------------------------------- bundle adjust

def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate); M: (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
            torch.stack([Cc, -(a * h - b * g), (a * e - b * d)], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def _lm_step(problem: BAProblem, poses, points, lam, use_robust):
    """One damped Gauss-Newton step; returns (new_poses, new_points,
    cost at the current state, cost at the new state)."""
    C = poses.shape[0]
    P = points.shape[0]
    cam, pt = problem.cam_idx, problem.pt_idx
    r, Jc, Jp, behind, is_st = _residual_jacobians(
        poses[cam], points[pt], problem.uv, problem.ur, problem.K, problem.bf)
    w, _, loss = _robust_weights(r, problem.sigma2, is_st, use_robust)
    active = problem.valid & ~behind
    w = torch.where(active, w, torch.zeros_like(w))
    Jc = torch.where((~problem.fixed[cam])[:, None, None], Jc, torch.zeros_like(Jc))
    cost = torch.sum(torch.where(active, loss, torch.zeros_like(loss)))

    Jcw = Jc * w[:, None, None]
    Jpw = Jp * w[:, None, None]
    dt = r.dtype
    dev = r.device
    Hcc = torch.zeros((C, 6, 6), dtype=dt, device=dev).index_add_(
        0, cam, torch.einsum("nij,nik->njk", Jcw, Jc))
    Hpp = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
        0, pt, torch.einsum("nij,nik->njk", Jpw, Jp))
    bc = torch.zeros((C, 6), dtype=dt, device=dev).index_add_(
        0, cam, torch.einsum("nij,ni->nj", Jcw, r))
    bp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(
        0, pt, torch.einsum("nij,ni->nj", Jpw, r))
    Hcp = torch.einsum("nij,nik->njk", Jcw, Jp)                      # (O, 6, 3)

    lamD_p = lam * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6)
    Hpp_inv = _inv3x3(Hpp + torch.diag_embed(lamD_p))
    Y = torch.einsum("oij,ojk->oik", Hcp, Hpp_inv[pt])               # (O, 6, 3)

    # exact Schur cross term: per-observation blocks scattered into per-
    # (point, camera) rows, then one (6C, 3P) x (3P, 6C) product
    lin = pt * C + cam
    A = torch.zeros((P * C, 18), dtype=dt, device=dev).index_add_(0, lin, Y.reshape(-1, 18))
    B = torch.zeros((P * C, 18), dtype=dt, device=dev).index_add_(0, lin, Hcp.reshape(-1, 18))
    A2 = A.reshape(P, C, 6, 3).permute(0, 3, 1, 2).reshape(P * 3, C * 6)
    B2 = B.reshape(P, C, 6, 3).permute(0, 3, 1, 2).reshape(P * 3, C * 6)
    S_cross = A2.T @ B2

    lamD_c = lam * torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-6)
    Hcc_d = Hcc + torch.diag_embed(lamD_c)
    S = torch.block_diag(*Hcc_d) - S_cross
    b_schur = bc.reshape(-1) - A2.T @ bp.reshape(-1)
    fixed6 = torch.repeat_interleave(problem.fixed, 6)
    S = torch.where(fixed6[:, None] | fixed6[None, :], torch.zeros_like(S), S)
    S = S + torch.diag(torch.where(fixed6, 1.0, 1e-9).to(dt))
    rhs = torch.where(fixed6, torch.zeros_like(b_schur), -b_schur)
    dscale = torch.rsqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    S_eq = S * dscale[:, None] * dscale[None, :]
    dc = (torch.linalg.solve_ex(S_eq, rhs * dscale)[0] * dscale).reshape(C, 6)

    t_obs = torch.einsum("oij,oi->oj", Hcp, dc[cam])
    tp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(0, pt, t_obs)
    dp = torch.einsum("pij,pj->pi", Hpp_inv, -bp - tp)

    new_poses = lie.se3_exp(dc) @ poses
    new_poses = torch.where(problem.fixed[:, None, None], poses, new_poses)
    new_points = points + dp
    new_cost, _, _ = ba_cost_and_chi2(problem._replace(poses=new_poses, points=new_points),
                                      use_robust)
    return new_poses, new_points, cost, new_cost


def bundle_adjust(problem: BAProblem, iters: int = 10, use_robust: bool = True,
                  lam0=None, return_state: bool = False):
    """Joint pose + point LM with the exact Schur complement.

    Returns (poses, points, final_cost), or with ``return_state``
    (poses, points, cost, lam, inlier mask): feeding ``lam`` back as
    ``lam0`` makes a run of N then M iterations identical to one run of
    N + M, which the chunked local BA relies on."""
    poses, points = problem.poses, problem.points
    cost, _, _ = ba_cost_and_chi2(problem, use_robust)
    lam = (torch.tensor(1e-4, dtype=poses.dtype, device=poses.device) if lam0 is None
           else torch.as_tensor(lam0, dtype=poses.dtype, device=poses.device))
    for _ in range(iters):
        new_poses, new_points, cur_cost, new_cost = _lm_step(problem, poses, points,
                                                             lam, use_robust)
        accept = new_cost < cur_cost
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e8))
        cost = torch.where(accept, new_cost, cost)
    if return_state:
        inl = ba_outlier_mask(problem._replace(poses=poses, points=points))
        return poses, points, cost, lam, inl
    return poses, points, cost
