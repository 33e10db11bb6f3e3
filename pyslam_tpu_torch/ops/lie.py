"""SO(3)/SE(3) Lie-group operations on tensors (port of the SE(3) part of
``pyslam_tpu/ops/lie.py``; Sim(3) comes with the loop-closing slice).

Every function takes leading batch dimensions.  Small-angle branches use the
same Taylor expansions behind ``torch.where`` as the reference.  Twists are
ordered [rho (translation), w (rotation)], as in g2o.
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
