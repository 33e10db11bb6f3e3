"""Spatially distributed keypoint selection from score maps: grid top-k
(port of ``pyslam_tpu/ops/nms.py:22``).

Ties are broken as ``jax.lax.top_k`` breaks them, lower index first: FAST
scores of 8-bit images tie often, and CPU ``torch.topk`` does not keep that
order, so both selections use a stable descending sort.
"""

from __future__ import annotations

import torch


def _topk_stable(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_topk_keypoints(score: torch.Tensor, cell: int = 16, per_cell: int = 4,
                        max_out: int = 1000):
    """Select up to ``max_out`` keypoints from (B, H, W) score maps.

    1. tile each map into (cell x cell) blocks,
    2. keep the ``per_cell`` best responses per block,
    3. global top-``max_out`` among survivors.

    Returns (xy: (B, max_out, 2) float32 [x, y], scores: (B, max_out),
    valid: (B, max_out) bool); invalid slots hold zeros.
    """
    b, h, w = score.shape
    gh = -(-h // cell)
    gw = -(-w // cell)
    s = torch.nn.functional.pad(score, (0, gw * cell - w, 0, gh * cell - h), value=0.0)
    s = torch.where(s <= 0.0, torch.full_like(s, float("-inf")), s)
    blocks = (s.reshape(b, gh, cell, gw, cell).permute(0, 1, 3, 2, 4)
              .reshape(b, gh * gw, cell * cell))
    vals, idx = _topk_stable(blocks, per_cell)          # (B, G, per_cell)

    g = torch.arange(gh * gw, device=score.device)[:, None]
    ys = (g // gw) * cell + idx // cell
    xs = (g % gw) * cell + idx % cell
    flat_vals = vals.reshape(b, -1)
    flat_ys = ys.reshape(b, -1)
    flat_xs = xs.reshape(b, -1)

    k = min(max_out, flat_vals.shape[1])
    top_vals, top_i = _topk_stable(flat_vals, k)
    sel_y = torch.gather(flat_ys, 1, top_i)
    sel_x = torch.gather(flat_xs, 1, top_i)
    valid = torch.isfinite(top_vals)
    xy = torch.stack([sel_x, sel_y], -1).to(torch.float32)
    scores = torch.where(valid, top_vals, torch.zeros_like(top_vals))
    if k < max_out:
        pad = max_out - k
        xy = torch.cat([xy, xy.new_zeros((b, pad, 2))], 1)
        scores = torch.cat([scores, scores.new_zeros((b, pad))], 1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], 1)
    return xy, scores, valid
