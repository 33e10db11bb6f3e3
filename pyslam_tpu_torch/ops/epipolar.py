"""Batched-hypothesis RANSAC for two-view geometry: the essential matrix
with cheirality pose recovery, and the homography (port of
``pyslam_tpu/ops/epipolar.py``).

A fixed batch of minimal samples is drawn at once: every hypothesis scores
each correspondence with Gumbel noise plus its log-weight, invalid rows get
-inf, and the hypothesis takes its ``sample_size`` best rows (sampling
without replacement within a hypothesis, probability proportional to the
weight).  Every hypothesis is solved in one batch (8-point for E, 4-point
DLT for H: the null vector of a (K, 9, 9) ``eigh``), scored against every
correspondence as one (K, N) residual matrix, and the first of the highest
inlier counts wins; E is then re-estimated on its inliers.  The draws come
from an explicit ``torch.Generator`` on the tensors' device, so they differ
from the reference's threefry keys by design: the solvers take ``samples=``
and the parity tests inject the reference's minimal sets.  The small linear
algebra (``eigh``, ``svd``) stays ``torch.linalg``, as the reference leaves
it to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from pyslam_tpu_torch.ops import geometry, lie


def _sample_minimal(valid: torch.Tensor, num_hyp: int, sample_size: int,
                    weights: torch.Tensor | None = None, *,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """(num_hyp, sample_size) int64 row indices drawn over the valid rows;
    equal scores keep the lower index first (stable sort)."""
    n = valid.shape[0]
    u = torch.rand((num_hyp, n), generator=generator, device=valid.device)
    tiny = torch.finfo(u.dtype).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    if weights is not None:
        g = g + torch.log(torch.clamp(weights.to(g.dtype), min=1e-20))
    g = torch.where(valid, g, torch.full((), float("-inf"), device=g.device))
    return torch.sort(g, dim=-1, descending=True, stable=True)[1][:, :sample_size]


def generator_sampler(device: torch.device, seed: int):
    """The default minimal-sample source of the RANSAC callers:
    ``_sample_minimal`` on one ``torch.Generator`` seeded ``seed``.  A
    sampler takes (valid, num_hyp, sample_size, weights) and returns
    (num_hyp, sample_size) row indices."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def sample(valid, num_hyp, sample_size, weights=None):
        return _sample_minimal(valid, num_hyp, sample_size, weights, generator=gen)

    return sample


def _draw(valid, num_hyp, sample_size, generator, samples):
    if samples is None:
        samples = _sample_minimal(valid, num_hyp, sample_size, generator=generator)
    return samples.to(device=valid.device, dtype=torch.int64)


# ------------------------------------------------------ essential matrix

def _epipolar_rows(xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """(..., n, 9) rows of x2ᵀ E x1 = 0 in normalised coordinates."""
    x1, y1 = xy1[..., 0], xy1[..., 1]
    x2, y2 = xy2[..., 0], xy2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], -1)


def _project_essential(AtA: torch.Tensor) -> torch.Tensor:
    """Null vector of (..., 9, 9) AᵀA as E, projected onto the essential
    manifold (singular values 1, 1, 0)."""
    _, vecs = torch.linalg.eigh(AtA)
    E = vecs[..., :, 0].reshape(*AtA.shape[:-2], 3, 3)
    U, _, Vh = torch.linalg.svd(E)
    return (U * torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)) @ Vh


def _eight_point(xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """8-point essential matrices of (..., 8, 2) minimal samples."""
    A = _epipolar_rows(xy1, xy2)
    return _project_essential(A.transpose(-1, -2) @ A)


def _weighted_eight_point(xy1, xy2, w):
    """Least-squares 8-point over all (N, 2) correspondences weighted by w."""
    A = _epipolar_rows(xy1, xy2)
    return _project_essential((A * w[:, None]).T @ A)


def _sampson_error(E: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance of every correspondence
    under (..., 3, 3) essential matrices: (..., N)."""
    ones = torch.ones_like(xy1[..., :1])
    p1 = torch.cat([xy1, ones], -1)
    p2 = torch.cat([xy2, ones], -1)
    Ex1 = p1 @ E.transpose(-1, -2)          # (..., N, 3) = E x1
    Etx2 = p2 @ E                           # (..., N, 3) = Eᵀ x2
    x2Ex1 = torch.sum(p2 * Ex1, -1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return x2Ex1 * x2Ex1 / torch.clamp(denom, min=1e-12)


def find_essential(xy1: torch.Tensor, xy2: torch.Tensor, valid: torch.Tensor,
                   threshold: float, num_hyp: int = 512, *,
                   generator: torch.Generator | None = None,
                   samples: torch.Tensor | None = None):
    """RANSAC essential matrix from (N, 2) normalised coordinates;
    ``threshold`` is a squared Sampson distance in normalised units (a
    pixel threshold px becomes (px / f)²).  ``samples`` (K, 8) replaces the
    draw.  Returns (E (3, 3), inlier mask (N,), number of inliers)."""
    samples = _draw(valid, num_hyp, 8, generator, samples)
    Es = _eight_point(xy1[samples], xy2[samples])                     # (K, 3, 3)
    inl = (_sampson_error(Es, xy1, xy2) < threshold) & valid[None, :]
    best = torch.argmax(torch.sum(inl, 1))
    E_best, mask = Es[best], inl[best]
    # refinement: least-squares 8-point on the best hypothesis' inliers
    E_ref = _weighted_eight_point(xy1, xy2, mask.to(xy1.dtype))
    mask_ref = (_sampson_error(E_ref, xy1, xy2) < threshold) & valid
    use_ref = torch.sum(mask_ref) >= torch.sum(mask)
    mask_out = torch.where(use_ref, mask_ref, mask)
    return torch.where(use_ref, E_ref, E_best), mask_out, torch.sum(mask_out)


def recover_pose(E: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor, valid: torch.Tensor):
    """Cheirality test of the 4 poses of E (cv2.recoverPose): each
    candidate triangulates every correspondence, and the first with the
    most points in front of both cameras wins.  Returns T_21 (4, 4), cam1
    -> cam2 with a unit translation, and its in-front mask (N,)."""
    U, _, Vh = torch.linalg.svd(E)
    one = torch.ones((), dtype=E.dtype, device=E.device)
    U = U * torch.where(torch.linalg.det(U) < 0, -one, one)
    Vh = Vh * torch.where(torch.linalg.det(Vh) < 0, -one, one)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype,
                     device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[:, 2]
    Ts = lie.rt_to_T(torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t]))   # (4, 4, 4)
    T1 = torch.eye(4, dtype=E.dtype, device=E.device).expand(4, 4, 4)
    pts = geometry.triangulate_dlt(T1, Ts, xy1, xy2)                                 # (4, N, 3)
    z2 = lie.transform_points(Ts, pts)[..., 2]
    good = (pts[..., 2] > 0) & (z2 > 0) & valid[None, :]
    best = torch.argmax(torch.sum(good, 1))
    return Ts[best], good[best]


# ---------------------------------------------------------- homography

def _four_point_h(xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """DLT homographies of (..., 4, 2) samples, normalised by H[2, 2]."""
    x, y = xy1[..., 0], xy1[..., 1]
    u, v = xy2[..., 0], xy2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r0 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    A = torch.stack([r0, r1], -2).reshape(*x.shape[:-1], 2 * x.shape[-1], 9)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    H = vecs[..., :, 0].reshape(*A.shape[:-2], 3, 3)
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22)


def _h_transfer_error(H, xy1, xy2):
    """Squared transfer distance |H x1 - x2|² of every correspondence under
    (..., 3, 3) homographies: (..., N)."""
    p1 = torch.cat([xy1, torch.ones_like(xy1[..., :1])], -1)
    q = p1 @ H.transpose(-1, -2)
    qz = q[..., 2:3]
    qz = torch.where(torch.abs(qz) < 1e-12, torch.full_like(qz, 1e-12), qz)
    return torch.sum((q[..., :2] / qz - xy2) ** 2, -1)


def find_homography(xy1: torch.Tensor, xy2: torch.Tensor, valid: torch.Tensor,
                    threshold: float, num_hyp: int = 256, *,
                    generator: torch.Generator | None = None,
                    samples: torch.Tensor | None = None):
    """RANSAC homography (pixel or normalised coordinates with a matching
    squared threshold); ``samples`` (K, 4) replaces the draw.  Returns
    (H (3, 3), inlier mask (N,), number of inliers)."""
    samples = _draw(valid, num_hyp, 4, generator, samples)
    Hs = _four_point_h(xy1[samples], xy2[samples])
    inl = (_h_transfer_error(Hs, xy1, xy2) < threshold) & valid[None, :]
    scores = torch.sum(inl, 1)
    best = torch.argmax(scores)
    return Hs[best], inl[best], scores[best]
