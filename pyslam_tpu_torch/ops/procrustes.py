"""Closed-form similarity / rigid alignment (Umeyama) and batched-hypothesis
Sim(3) RANSAC (port of ``pyslam_tpu/ops/procrustes.py:22-177``).

The minimal solver is the 3-point weighted Umeyama; the K hypotheses are
solved as one batch, scored against every correspondence as one (K, N)
error matrix, and the best is the first of the highest inlier count.  The
winner is then refined by a weighted Umeyama over its inliers and kept only
if it does not lose inliers.  ``samples`` (K, 3) replaces the random draw
(the parity tests pass the reference's samples through it).
"""

from __future__ import annotations

import torch

from pyslam_tpu_torch.ops import lie
from pyslam_tpu_torch.ops.epipolar import _sample_minimal


def umeyama(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None,
            with_scale: bool = True):
    """Weighted Umeyama: (s, R, t) minimising sum_i w_i ||dst_i - (s R src_i
    + t)||^2 for (..., N, 3) point sets; ``with_scale=False`` is the rigid
    case (s = 1)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(torch.sum(weights, -1), min=1e-12)
    w = weights / wsum[..., None]
    mu_s = torch.sum(src * w[..., None], -2)
    mu_d = torch.sum(dst * w[..., None], -2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (dc * w[..., None]).transpose(-1, -2) @ sc
    U, S, Vh = torch.linalg.svd(cov)
    d = torch.sign(lie.det3(U) * lie.det3(Vh))
    one = torch.ones_like(d)
    D = torch.stack([one, one, d], -1)
    R = (U * D[..., None, :]) @ Vh
    var_s = torch.sum(w * torch.sum(sc * sc, -1), -1)
    if with_scale:
        s = torch.sum(S * D, -1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones_like(var_s)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


def umeyama_S(src, dst, weights=None, with_scale: bool = True) -> torch.Tensor:
    """Umeyama as a (..., 4, 4) Sim(3) matrix mapping src -> dst."""
    return lie.srt_to_S(*umeyama(src, dst, weights, with_scale))


def _draw(valid, num_hyp, weights, generator, samples):
    if samples is not None:
        return samples.to(device=valid.device, dtype=torch.int64)
    return _sample_minimal(valid, num_hyp, 3, weights, generator=generator)


def _best_and_refine(Ss, errs_fn, valid, threshold, solve_weighted):
    errs = errs_fn(Ss)                                        # (K, N)
    inl = (errs < threshold) & valid[None, :]
    best = torch.argmax(torch.sum(inl, 1))
    mask = inl[best]
    S_ref = solve_weighted(mask)
    mask_ref = (errs_fn(S_ref) < threshold) & valid
    use_ref = torch.sum(mask_ref) >= torch.sum(mask)
    S_out = torch.where(use_ref, S_ref, Ss[best])
    mask_out = torch.where(use_ref, mask_ref, mask)
    return S_out, mask_out, torch.sum(mask_out)


def sim3_ransac(pts1: torch.Tensor, pts2: torch.Tensor, valid: torch.Tensor,
                threshold2: float, num_hyp: int = 256, with_scale: bool = True, *,
                generator: torch.Generator | None = None,
                samples: torch.Tensor | None = None):
    """RANSAC Sim(3) (or SE(3)) mapping pts1 -> pts2, scored by the squared
    3-D distance.  Returns (S_21 (4, 4), inlier mask, count)."""
    idx = _draw(valid, num_hyp, None, generator, samples)
    Ss = umeyama_S(pts1[idx], pts2[idx], with_scale=with_scale)     # (K, 4, 4)

    def errs(S):
        return torch.sum((lie.sim3_transform_points(S, pts1) - pts2) ** 2, -1)

    return _best_and_refine(
        Ss, errs, valid, threshold2,
        lambda m: umeyama_S(pts1, pts2, weights=m.to(pts1.dtype), with_scale=with_scale))


def _project(K, p):
    z = torch.clamp(p[..., 2], min=1e-6)
    return K[0, 0] * p[..., 0] / z + K[0, 2], K[1, 1] * p[..., 1] / z + K[1, 2]


def mutual_reproj_err2(S, pts1_c1, pts2_c2, uv1, uv2, sigma2_1, sigma2_2, K1, K2):
    """Per correspondence, the larger of its chi2 in image 1 (pts2 through
    S) and in image 2 (pts1 through S^-1); S may carry a leading batch."""
    u1, v1 = _project(K1, lie.sim3_transform_points(S, pts2_c2))
    e1 = ((u1 - uv1[:, 0]) ** 2 + (v1 - uv1[:, 1]) ** 2) / torch.clamp(sigma2_1, min=1e-9)
    u2, v2 = _project(K2, lie.sim3_transform_points(lie.sim3_inv(S), pts1_c1))
    e2 = ((u2 - uv2[:, 0]) ** 2 + (v2 - uv2[:, 1]) ** 2) / torch.clamp(sigma2_2, min=1e-9)
    return torch.maximum(e1, e2)


def sim3_ransac_reproj(pts1_c1, pts2_c2, uv1, uv2, sigma2_1, sigma2_2, valid, K1, K2,
                       chi2_th: float = 9.21, num_hyp: int = 256, with_scale: bool = True,
                       sample_weights: torch.Tensor | None = None, *,
                       generator: torch.Generator | None = None,
                       samples: torch.Tensor | None = None):
    """RANSAC Sim(3) scored by mutual reprojection (``mutual_reproj_err2``,
    the reference Sim3Solver's scoring).
    ``sample_weights`` bias the minimal sets (probability proportional to the
    weight); every correspondence still votes.  Returns (S12 mapping cam-2
    coordinates to cam-1 coordinates, inlier mask, count)."""
    idx = _draw(valid, num_hyp, sample_weights, generator, samples)
    Ss = umeyama_S(pts2_c2[idx], pts1_c1[idx], with_scale=with_scale)  # (K, 4, 4)

    def errs(S):
        return mutual_reproj_err2(S, pts1_c1, pts2_c2, uv1, uv2, sigma2_1, sigma2_2, K1, K2)

    return _best_and_refine(
        Ss, errs, valid, chi2_th,
        lambda m: umeyama_S(pts2_c2, pts1_c1, weights=m.to(pts1_c1.dtype),
                            with_scale=with_scale))
