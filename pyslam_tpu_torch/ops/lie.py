"""SO(3)/SE(3)/Sim(3) Lie-group operations on tensors (port of
``pyslam_tpu/ops/lie.py``).

Every function takes leading batch dimensions.  Small-angle branches use the
same Taylor expansions behind ``torch.where`` as the reference: both branches
are evaluated and only the denominators are guarded, so forward-mode
Jacobians at zero (``torch.func.jvp``) go through the Taylor branches as
they do in the reference's ``jax.jacfwd``.  Twists are ordered [rho (translation), w
(rotation)], as in g2o; Sim(3) twists append sigma = log(scale).  3x3
determinants and solves are closed forms (cofactors), which batch and
differentiate without a linear-algebra library call.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def _eye3(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-10
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * W2


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-10
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * W2


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-10
    half = theta * 0.5
    one = torch.ones_like(theta)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(small, one, torch.sin(half)))
        / torch.where(small, one, theta2),
    )
    return _eye3(w) - 0.5 * W + cot_term[..., None, None] * W2


def rt_to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) homogeneous."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(*R.shape[:-2], 1, 4)
    top = torch.cat([R, t[..., :, None]], -1)
    return torch.cat([top, bottom], -2)


def T_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) [rho, w] -> (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_left_jacobian(w) @ rho[..., None])[..., 0]
    return rt_to_T(R, t)


def R_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> quaternion (x, y, z, w), branchless Shepperd method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw0 = safe_sqrt(1.0 + tr) * 0.5
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4 * qw0 * qw0], -1) / (
        4.0 * qw0[..., None])
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) * 0.5
    q1 = torch.stack([4 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12], -1) / (
        4.0 * qx1[..., None])
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) * 0.5
    q2 = torch.stack([m01 + m10, 4 * qy2 * qy2, m12 + m21, m02 - m20], -1) / (
        4.0 * qy2[..., None])
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) * 0.5
    q3 = torch.stack([m02 + m20, m12 + m21, 4 * qz3 * qz3, m10 - m01], -1) / (
        4.0 * qz3[..., None])
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    idx = torch.argmax(scores, -1)
    qs = torch.stack([q0, q1, q2, q3], -2)
    q = torch.take_along_dim(qs, idx[..., None, None].expand(*idx.shape, 1, 4),
                             -2)[..., 0, :]
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> axis-angle (angle in [0, pi]) through the quaternion."""
    q = R_to_quat(R)
    v, qw = q[..., :3], q[..., 3]
    sgn = torch.where(qw < 0.0, -1.0, 1.0)
    v = v * sgn[..., None]
    qw = qw * sgn
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, qw)
    small = vn < 1e-9
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS),
                        theta / torch.where(small, torch.ones_like(vn), vn))
    return v * scale[..., None]


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> twist (..., 6) [rho, w]."""
    R, t = T_to_rt(T)
    w = so3_log(R)
    rho = (_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return torch.cat([rho, w], -1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to (..., N, 3) points."""
    R, t = T_to_rt(T)
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def project_to_SO3(M: torch.Tensor) -> torch.Tensor:
    """Closest rotation to M (SVD projection with the determinant fixed)."""
    U, _, Vh = torch.linalg.svd(M)
    det = det3(U @ Vh)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], -1)
    return (U * D[..., None, :]) @ Vh


# ----------------------------------------------------------------- Sim(3)

def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices by cofactor expansion."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def solve3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., 3, 3) x = (..., 3) by Cramer's rule."""
    c0, c1, c2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]

    def det_cols(u, v, w):
        return det3(torch.stack([u, v, w], -1))

    return torch.stack([det_cols(b, c1, c2), det_cols(c0, b, c2), det_cols(c0, c1, b)],
                       -1) / det3(M)[..., None]


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) [rho(3), w(3), sigma(1)] -> (..., 4, 4) [sR t; 0 1]."""
    rho, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(w)
    t = (_sim3_W(w, sigma) @ rho[..., None])[..., 0]
    return srt_to_S(s, R, t)


def srt_to_S(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return rt_to_T(s[..., None, None] * R, t)


def S_to_srt(S: torch.Tensor):
    """(..., 4, 4) Sim(3) -> (s, R, t)."""
    sR = S[..., :3, :3]
    s = _cbrt(det3(sR))
    return s, sR / s[..., None, None], S[..., :3, 3]


def sim3_inv(S: torch.Tensor) -> torch.Tensor:
    s, R, t = S_to_srt(S)
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return srt_to_S(s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0])


def sim3_transform_points(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ S[..., :3, :3].transpose(-1, -2) + S[..., :3, 3][..., None, :]


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> [rho, w, sigma], the inverse of ``sim3_exp``."""
    s, R, t = S_to_srt(S)
    sigma = torch.log(s)
    w = so3_log(R)
    rho = solve3(_sim3_W(w, sigma), t)
    return torch.cat([rho, w, sigma[..., None]], -1)


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Translation block of the Sim(3) exponential, W = A0 I + a hat(w) +
    b hat(w)^2, with the Taylor limits of the reference for small theta
    and/or small sigma (guarded denominators only, both branches evaluated).
    """
    s = torch.exp(sigma)
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta2 < 1e-10
    one = torch.ones_like(sigma)
    ssig = torch.where(small_sigma, one, sigma)
    ssig2 = ssig * ssig
    A0 = torch.where(small_sigma, 1.0 + sigma / 2.0, (s - 1.0) / ssig)
    denom = sigma * sigma + theta2
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a_big = (s * sin_t * sigma + (1.0 - s * cos_t) * theta) / (theta * denom)
    b_big = (A0 - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / denom) / torch.where(
        small_theta, one, theta2)
    a_small = torch.where(small_sigma, 0.5 * one, (s * sigma + 1.0 - s) / ssig2)
    b_small = torch.where(small_sigma, one / 6.0, (A0 + s * sigma / 2.0 - s) / ssig2)
    a = torch.where(small_theta, a_small, a_big)
    b = torch.where(small_theta, b_small, b_big)
    return A0[..., None, None] * _eye3(w) + a[..., None, None] * W + b[..., None, None] * W2
