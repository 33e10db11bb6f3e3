"""SLAM matching: projection search, epipolar search for triangulation, and
fusion candidates (port of ``pyslam_tpu/ops/slam_matching.py:26-399``).

Each search is one masked dense problem: project the candidate map points,
build the (M, N) Hamming matrix, AND in the geometric gates (radius scaled
by the predicted octave, scale-invariance range, viewing angle, octave
agreement, epipolar distance), then a masked one-to-one argmin.  The
descriptor distance dispatches on the dtype as the reference's does
(``hamming.descriptor_distance_matrix``: Hamming for bits, L2 for floats).  -1 marks no
match.  The back-end matchers batch over neighbour keyframes, which
``fuse_candidates_kfstore`` gathers from the stacked device store
(``slam/kf_device_store.py``).
"""

from __future__ import annotations

import torch

from pyslam_tpu_torch.ops import hamming, lie, matching


def _project(pts_w, Tcw, K):
    pc = lie.transform_points(Tcw, pts_w)
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
    return z, zs, u, v


def _point_gates(pts_w, pt_normal, pt_min_dist, pt_max_dist, pt_valid, Tcw,
                 z, u, v, image_bounds, scale_factors, view_cos_limit):
    """Per-point visibility gates and the predicted octave."""
    L = scale_factors.shape[0]
    Ow = -Tcw[..., :3, :3].transpose(-1, -2) @ Tcw[..., :3, 3:4]
    d = pts_w - Ow[..., 0][..., None, :]
    dist = torch.linalg.norm(d, dim=-1)
    view_cos = torch.sum(d * pt_normal, -1) / torch.clamp(dist, min=1e-9)
    in_img = ((u >= image_bounds[0]) & (u < image_bounds[1])
              & (v >= image_bounds[2]) & (v < image_bounds[3]))
    in_range = (dist >= pt_min_dist * 0.8) & (dist <= pt_max_dist * 1.2)
    pt_ok = pt_valid & (z > 0) & in_img & in_range & (view_cos > view_cos_limit)
    # a one-level extractor (SURF, Shi-Tomasi): the reference's gather
    # clamps the index to level 0, and every predicted level clamps to 0
    log_scale = torch.log(scale_factors[min(1, L - 1)] / scale_factors[0])
    ratio_d = torch.clamp(pt_max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
    pred_level = torch.clamp(torch.ceil(torch.log(ratio_d) / log_scale).to(torch.int64),
                             0, L - 1)
    return pt_ok, pred_level


def search_by_projection(pts_w, pt_desc, pt_normal, pt_min_dist, pt_max_dist, pt_valid,
                         kps, kp_level, kp_desc, kp_valid, kp_ur, Tcw, K, image_bounds,
                         scale_factors, radius_px, max_descriptor_distance,
                         view_cos_limit: float = 0.5, ratio: float = 0.9):
    """Project map points (M) into a frame (N keypoints) and match.

    Returns (pt_match_kp: (M,) kp index or -1, kp_match_pt: (N,) point row
    or -1, pred_level: (M,))."""
    z, _, u, v = _project(pts_w, Tcw, K)
    pt_ok, pred_level = _point_gates(pts_w, pt_normal, pt_min_dist, pt_max_dist,
                                     pt_valid, Tcw, z, u, v, image_bounds,
                                     scale_factors, view_cos_limit)
    radius = radius_px * scale_factors[pred_level]
    du = torch.abs(kps[None, :, 0] - u[:, None])
    dv = torch.abs(kps[None, :, 1] - v[:, None])
    in_window = (du < radius[:, None]) & (dv < radius[:, None])
    level_ok = ((kp_level[None, :] >= pred_level[:, None] - 1)
                & (kp_level[None, :] <= pred_level[:, None] + 1))
    pair_ok = in_window & level_ok & pt_ok[:, None] & kp_valid[None, :]
    dmat = hamming.descriptor_distance_matrix(pt_desc, kp_desc)
    idx, _ = matching.match_ratio_test(dmat, max_descriptor_distance, ratio=ratio,
                                       valid_a=pt_ok, valid_b=kp_valid,
                                       cross_check=True, extra_mask=pair_ok)
    m, n = pts_w.shape[0], kps.shape[0]
    kp_match = torch.full((n + 1,), -1, dtype=torch.int64, device=kps.device)
    rows = torch.arange(m, device=kps.device)
    kp_match = kp_match.scatter(0, torch.where(idx >= 0, idx, n),
                                torch.where(idx >= 0, rows, -1))[:n]
    return idx, kp_match, pred_level


def epipolar_triangulation_match(kps1, level1, desc1, free1, kps2, level2, desc2, free2,
                                 F12, epipole2, sigma2_levels, max_descriptor_distance,
                                 ratio: float = 0.8):
    """Descriptor matching of keyframe 1 against (B,)-stacked keyframes 2
    under the epipolar constraint (chi2 gate on the point-to-epiline
    distance, scaled by the level-2 sigma2) and away from the epipole.

    kps2/level2/desc2/free2 carry a leading (B,) axis, as do F12 (B, 3, 3)
    and epipole2 (B, 2).  Returns idx2 (B, N1) or -1."""
    ones = torch.ones_like(kps1[:, :1])
    p1 = torch.cat([kps1, ones], 1)                               # (N1, 3)
    lines2 = p1 @ F12.transpose(-1, -2)                           # (B, N1, 3)
    a, b, c = lines2[..., 0:1], lines2[..., 1:2], lines2[..., 2:3]
    num = a * kps2[:, None, :, 0] + b * kps2[:, None, :, 1] + c   # (B, N1, N2)
    den = a * a + b * b
    dsq = num * num / torch.clamp(den, min=1e-12)
    s2 = sigma2_levels[level2]                                    # (B, N2)
    epi_ok = dsq < 3.84 * s2[:, None, :]
    de = torch.sum((kps2 - epipole2[:, None, :]) ** 2, -1)
    far_from_epipole = de > 100.0 * s2
    pair_ok = epi_ok & free1[None, :, None] & (free2 & far_from_epipole)[:, None, :]
    dmat = hamming.descriptor_distance_matrix(desc1[None], desc2)
    idx2, _ = matching.match_ratio_test(
        dmat, max_descriptor_distance, ratio=ratio,
        valid_a=free1.expand(kps2.shape[0], -1), valid_b=free2,
        cross_check=True, extra_mask=pair_ok)
    return idx2


def fuse_candidates(pts_w, pt_desc, pt_normal, pt_min_dist, pt_max_dist, pt_valid,
                    kps, kp_level, kp_desc, kp_valid, kp_ur, Tcw, K, bf, image_bounds,
                    scale_factors, sigma2_levels, max_descriptor_distance):
    """search-and-fuse device part, batched over (B,) target keyframes:
    for each candidate map point the best in-window keypoint whose
    reprojection chi2 passes.

    Point arrays are (B, M, ...) (a per-target candidate mask in pt_valid),
    keyframe arrays (B, N, ...), Tcw (B, 4, 4).  Returns (best_kp (B, M) or
    -1, best_dist (B, M))."""
    z, zs, u, v = _project(pts_w, Tcw, K)
    ur = u - bf / zs
    pt_ok, pred_level = _point_gates(pts_w, pt_normal, pt_min_dist, pt_max_dist,
                                     pt_valid, Tcw, z, u, v, image_bounds,
                                     scale_factors, 0.5)
    radius = 3.0 * scale_factors[pred_level]                      # (B, M)
    du = kps[:, None, :, 0] - u[..., None]                        # (B, M, N)
    dv = kps[:, None, :, 1] - v[..., None]
    in_window = (torch.abs(du) < radius[..., None]) & (torch.abs(dv) < radius[..., None])
    lvl = kp_level[:, None, :]
    level_ok = (lvl >= pred_level[..., None] - 1) & (lvl <= pred_level[..., None] + 1)
    s2 = sigma2_levels[kp_level][:, None, :]
    e2_mono = (du * du + dv * dv) / s2
    dur = kp_ur[:, None, :] - ur[..., None]
    e2_stereo = (du * du + dv * dv + dur * dur) / s2
    is_stereo = (kp_ur >= 0)[:, None, :]
    chi_ok = torch.where(is_stereo, e2_stereo <= 7.815, e2_mono <= 5.991)
    pair_ok = in_window & level_ok & chi_ok & pt_ok[..., None] & kp_valid[:, None, :]
    dmat = hamming.descriptor_distance_matrix(pt_desc, kp_desc)
    dmat = torch.where(pair_ok, dmat, torch.full((), matching.INF, device=dmat.device))
    best_kp = torch.argmin(dmat, -1)
    best_dist = torch.gather(dmat, -1, best_kp[..., None])[..., 0]
    ok = best_dist <= max_descriptor_distance
    return torch.where(ok, best_kp, torch.full_like(best_kp, -1)), best_dist


def fuse_candidates_kfstore(store_pos, store_desc, store_normal, store_min, store_max,
                            store_valid, cand_idx, cand_valid, s_kps, s_lvl, s_des,
                            s_val, s_ur, rows, Tcw, K, bf, image_bounds, scale_factors,
                            sigma2_levels, max_descriptor_distance):
    """``fuse_candidates`` over (B,) targets: ONE candidate row set gathered
    from the device point store, filtered per target by ``cand_valid``
    (B, M); the targets gathered from the keyframe store by ``rows``."""
    S = store_pos.shape[0]
    idx = torch.clamp(cand_idx, 0, S - 1)
    B = rows.shape[0]

    def rep(x):
        rows_x = x[idx]
        return rows_x.expand(B, *rows_x.shape)

    pvalid = (store_valid[idx] & (cand_idx >= 0))[None] & cand_valid
    return fuse_candidates(
        rep(store_pos), rep(store_desc), rep(store_normal), rep(store_min),
        rep(store_max), pvalid, s_kps[rows], s_lvl[rows], s_des[rows], s_val[rows],
        s_ur[rows], Tcw, K, bf, image_bounds, scale_factors, sigma2_levels,
        max_descriptor_distance)

