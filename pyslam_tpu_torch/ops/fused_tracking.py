"""The per-frame tracking step of the OK path as one device function (port
of ``pyslam_tpu/ops/fused_tracking.py:27-196``, depth 1).

search by projection against the previous frame's points (narrow radius,
widened when it finds too few), pose optimisation #1, search of the local
map from the refined pose, pose optimisation #2.  The widening retry is
evaluated on the device (both radii are searched), so the step needs no
host round trip before its single readback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pyslam_tpu_torch.ops import optim
from pyslam_tpu_torch.ops.slam_matching import search_by_projection


class FusedTrackResult(NamedTuple):
    """Tcw (4, 4); counts (3,) [n_prev, n_inl1, n_inl2]; match (N,) row per
    keypoint (see the producing function); inlier (N,) bool; match_dist
    (N,) Hamming distance of the match (inf where unmatched)."""

    Tcw: torch.Tensor
    counts: torch.Tensor
    match: torch.Tensor
    inlier: torch.Tensor
    match_dist: torch.Tensor


def track_frame_fused(kps, kp_level, kp_des, kp_valid, kp_ur,
                      prev_pos, prev_desc, prev_normal, prev_min_d, prev_max_d, prev_valid,
                      map_pos, map_desc, map_normal, map_min_d, map_max_d, map_valid,
                      Tcw_pred, K, image_bounds, scale_factors, sigma2_table, bf,
                      radius_frame, radius_frame_wide, radius_map, desc_th, ratio_map,
                      min_prev_matches: int = 20) -> FusedTrackResult:
    """One tracking step.  ``match`` per keypoint: row into the prev arrays,
    or Mp + row into the map arrays, or -1."""
    Mp = prev_pos.shape[0]
    Mm = map_pos.shape[0]
    sigma2 = sigma2_table[torch.clamp(kp_level, 0, sigma2_table.shape[0] - 1)]

    def search_prev(radius):
        return search_by_projection(
            prev_pos, prev_desc, prev_normal, prev_min_d, prev_max_d, prev_valid,
            kps, kp_level, kp_des, kp_valid, kp_ur, Tcw_pred, K, image_bounds,
            scale_factors, radius, desc_th, ratio=0.9)[1]

    kp_m1 = search_prev(radius_frame)
    n1 = torch.sum(kp_m1 >= 0)
    kp_m2 = search_prev(radius_frame_wide)
    kp_match_prev = torch.where(n1 >= min_prev_matches, kp_m1, kp_m2)
    n_prev = torch.sum(kp_match_prev >= 0)

    has1 = (kp_match_prev >= 0) & kp_valid
    pts1 = prev_pos[torch.clamp(kp_match_prev, 0, Mp - 1)]
    T1, inl1, n_inl1 = optim.pose_optimization(Tcw_pred, pts1, kps, kp_ur, sigma2, has1,
                                               K, bf=bf)
    keep_prev = has1 & inl1

    _, kp_match_map, _ = search_by_projection(
        map_pos, map_desc, map_normal, map_min_d, map_max_d, map_valid,
        kps, kp_level, kp_des, kp_valid, kp_ur, T1, K, image_bounds, scale_factors,
        radius_map, desc_th, ratio=ratio_map)
    use_map = (kp_match_map >= 0) & ~keep_prev & kp_valid
    map_rows = torch.clamp(kp_match_map, 0, Mm - 1)
    pts2 = torch.where(keep_prev[:, None], pts1, map_pos[map_rows])
    valid2 = keep_prev | use_map
    T2, inl2, n_inl2 = optim.pose_optimization(T1, pts2, kps, kp_ur, sigma2, valid2, K, bf=bf)

    minus1 = torch.full_like(kp_match_prev, -1)
    match = torch.where(keep_prev, kp_match_prev,
                        torch.where(use_map, Mp + kp_match_map, minus1))
    src_desc = torch.where(keep_prev[:, None],
                           prev_desc[torch.clamp(kp_match_prev, 0, Mp - 1)].to(torch.float32),
                           map_desc[map_rows].to(torch.float32))
    mdist = torch.where(valid2,
                        torch.sum(torch.abs(src_desc - kp_des.to(torch.float32)), 1),
                        torch.full_like(valid2, float("inf"), dtype=torch.float32))
    counts = torch.stack([n_prev, n_inl1, n_inl2])
    return FusedTrackResult(T2, counts, match, inl2, mdist)


def gather_store_rows(store, idx):
    """Rows ``idx`` (-1 = padding) of the device point store (pos, desc,
    normal, min_dist, max_dist, valid), with padded or dead rows made inert:
    zero position, unit range, invalid."""
    store_pos, store_desc, store_normal, store_min_d, store_max_d, store_valid = store
    cl = torch.clamp(idx, min=0)
    valid = (idx >= 0) & store_valid[cl]
    pos = torch.where(valid[:, None], store_pos[cl], torch.zeros_like(store_pos[cl]))
    max_d = torch.where(valid, store_max_d[cl], torch.ones_like(store_max_d[cl]))
    min_d = torch.where(valid, store_min_d[cl], torch.zeros_like(store_min_d[cl]))
    return pos, store_desc[cl], store_normal[cl], min_d, max_d, valid


def track_frame_fused_indexed(kps, kp_level, kp_des, kp_valid, kp_ur, store,
                              idx_prev, idx_map,
                              Tcw_pred, K, image_bounds, scale_factors, sigma2_table, bf,
                              radius_frame, radius_frame_wide, radius_map, desc_th,
                              ratio_map, min_prev_matches: int = 20) -> FusedTrackResult:
    """``track_frame_fused`` with the previous-frame and local-map points
    gathered from the device-resident point ``store`` (``Map.device_store()``)
    by row index (-1 = padding), and ``match`` resolved to absolute store
    rows (map-point ids) or -1."""
    res = track_frame_fused(
        kps, kp_level, kp_des, kp_valid, kp_ur, *gather_store_rows(store, idx_prev),
        *gather_store_rows(store, idx_map),
        Tcw_pred, K, image_bounds, scale_factors, sigma2_table, bf, radius_frame,
        radius_frame_wide, radius_map, desc_th, ratio_map,
        min_prev_matches=min_prev_matches)
    Mp = idx_prev.shape[0]
    Mm = idx_map.shape[0]
    code = res.match
    row = torch.where(
        code >= 0,
        torch.where(code < Mp, idx_prev[torch.clamp(code, 0, Mp - 1)],
                    idx_map[torch.clamp(code - Mp, 0, Mm - 1)]),
        torch.full_like(code, -1))
    return res._replace(match=row)
