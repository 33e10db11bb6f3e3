"""Masked descriptor matching on dense distance matrices (port of
``pyslam_tpu/ops/matching.py``).

Invalid rows/columns are masked with INF distance; index -1 means "no
match".  Every function accepts leading batch dimensions (the back-end
matches several keyframes in one call).  Tie rules follow the reference:
``argmin`` keeps the first index, the one-to-one resolution is a
scatter-min (``scatter_reduce(..., "amin")``), and the rotation histogram
picks its top bins lower index first.
"""

from __future__ import annotations

import torch

INF = 1e9


def mask_distance_matrix(dmat, valid_a=None, valid_b=None, extra_mask=None):
    """Set distances of invalid rows/cols (and masked pairs) to INF."""
    d = dmat.to(torch.float32)
    inf = torch.full((), INF, dtype=torch.float32, device=d.device)
    if valid_a is not None:
        d = torch.where(valid_a[..., :, None], d, inf)
    if valid_b is not None:
        d = torch.where(valid_b[..., None, :], d, inf)
    if extra_mask is not None:
        d = torch.where(extra_mask, d, inf)
    return d


def top2_along_rows(d: torch.Tensor):
    """Best and second-best per row: (d1, i1, d2)."""
    i1 = torch.argmin(d, -1)
    d1 = torch.gather(d, -1, i1[..., None])[..., 0]
    d_masked = d.scatter(-1, i1[..., None], INF)
    d2 = torch.amin(d_masked, -1)
    return d1, i1, d2


def match_ratio_test(dmat, max_distance: float, ratio: float = 0.75, valid_a=None,
                     valid_b=None, cross_check: bool = True, extra_mask=None):
    """KNN-2 matching with Lowe's ratio test and a one-to-one cross-check.

    Returns (idx_b: (..., N) int64, -1 for unmatched; dist: (..., N)).
    Each row takes its best column if d1 <= max_distance and d1 < ratio*d2;
    the cross-check keeps, per column, the row of minimal distance (lowest
    row id on ties)."""
    d = mask_distance_matrix(dmat, valid_a, valid_b, extra_mask)
    d1, i1, d2 = top2_along_rows(d)
    ok = (d1 <= max_distance) & (d1 < ratio * d2)
    if cross_check:
        n, m = d.shape[-2:]
        batch = d.shape[:-2]
        inf = torch.full((), INF, dtype=torch.float32, device=d.device)
        cand_d = torch.where(ok, d1, inf)
        col_min = torch.full((*batch, m), INF, dtype=torch.float32, device=d.device)
        col_min = col_min.scatter_reduce(-1, i1, cand_d, "amin")
        winner = cand_d <= torch.gather(col_min, -1, i1) + 1e-6
        row_ids = torch.arange(n, device=d.device).expand(*batch, n)
        sentinel = torch.full((), n, dtype=torch.int64, device=d.device)
        col_best = torch.full((*batch, m), n, dtype=torch.int64, device=d.device)
        col_best = col_best.scatter_reduce(
            -1, i1, torch.where(winner & ok, row_ids, sentinel), "amin")
        ok = ok & winner & (torch.gather(col_best, -1, i1) == row_ids)
    idx = torch.where(ok, i1, torch.full_like(i1, -1))
    return idx, torch.where(ok, d1, torch.full_like(d1, INF))


def match_nn(dmat, max_distance: float, valid_a=None, valid_b=None, extra_mask=None):
    """Plain nearest-neighbour matching with a distance gate (no ratio
    test, no cross-check): (idx_b (..., N) int64 or -1, dist (..., N))."""
    d = mask_distance_matrix(dmat, valid_a, valid_b, extra_mask)
    i1 = torch.argmin(d, -1)
    d1 = torch.gather(d, -1, i1[..., None])[..., 0]
    ok = d1 <= max_distance
    return (torch.where(ok, i1, torch.full_like(i1, -1)),
            torch.where(ok, d1, torch.full_like(d1, INF)))


def rotation_histogram_filter(angles_a, angles_b_matched, match_ok,
                              num_bins: int = 30, keep_top: int = 3):
    """Keep the matches whose angle difference (degrees) falls into one of
    the ``keep_top`` most populated of ``num_bins`` bins."""
    rot = angles_a - angles_b_matched
    rot = torch.where(rot < 0.0, rot + 360.0, rot)
    factor = num_bins / 360.0
    b = torch.round(rot * factor).to(torch.int64)
    b = torch.where(b == num_bins, torch.zeros_like(b), b)
    b = torch.clamp(b, 0, num_bins - 1)
    counts = torch.zeros(num_bins, dtype=torch.int64, device=b.device)
    counts = counts.scatter_add(0, b, match_ok.to(torch.int64))
    top_bins = torch.sort(counts, descending=True, stable=True)[1][:keep_top]
    in_top = torch.any(b[:, None] == top_bins[None, :], 1)
    return match_ok & in_top


def row_stereo_match(dmat, rows_a, rows_b, disp_a_minus_b, max_distance: float,
                     row_tol: float, min_disp: float, max_disp: float,
                     valid_a=None, valid_b=None, ratio: float = 0.9):
    """Rectified-stereo matching: only pairs on (almost) the same row with a
    disparity in [min_disp, max_disp] are candidates."""
    pair_ok = (
        (torch.abs(rows_a[..., :, None] - rows_b[..., None, :]) <= row_tol)
        & (disp_a_minus_b >= min_disp)
        & (disp_a_minus_b <= max_disp)
    )
    return match_ratio_test(dmat, max_distance, ratio=ratio, valid_a=valid_a,
                            valid_b=valid_b, cross_check=True, extra_mask=pair_ok)
