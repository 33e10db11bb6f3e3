"""Semi-global stereo matching in PyTorch (port of
``pyslam_tpu/depth_estimation/sgm.py``).

1. cost volume: census-transform Hamming costs over the disparity range,
2. semi-global aggregation along 4 scan directions with the P1/P2
   smoothness penalties; every scan line is cut into tiles of ``path_tile``
   pixels with a ``path_halo`` warm-up prefix (clamped at the border), and
   all tiles of all four directions advance together, one step of
   ``path_halo + path_tile`` at a time,
3. winner-take-all with a uniqueness ratio and parabola sub-pixel
   refinement,
4. left-right consistency check; invalid pixels get disparity -1.

Everything before the sub-pixel step holds small integers in float32
(census costs <= 24, path costs <= 24 + P2), so the cost volume, the
aggregated volume, the integer disparities and the masks are exact and
equal to the reference's in any summation order.  ``argmin`` keeps the
first index of a tie, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import torch

INVALID = -1.0


def census_transform(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """(H,W) -> (H,W,B) bool census bits over the (2r+1)^2-1 neighbourhood
    (edge padding): bit = neighbour < centre."""
    h, w = img.shape
    pads = torch.nn.functional.pad(img[None, None], (radius,) * 4, mode="replicate")[0, 0]
    bits = [pads[radius + dy:radius + dy + h, radius + dx:radius + dx + w] < img
            for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)
            if dy or dx]
    return torch.stack(bits, dim=-1)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., B <= 31) bool -> (...) int32 with bit i = bits[..., i]."""
    weights = torch.bitwise_left_shift(
        torch.ones(bits.shape[-1], dtype=torch.int32, device=bits.device),
        torch.arange(bits.shape[-1], dtype=torch.int32, device=bits.device))
    return (bits.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 values (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def cost_volume(census_l: torch.Tensor, census_r: torch.Tensor, max_disp: int) -> torch.Tensor:
    """(H,W,D) float32 Hamming cost between left pixel x and right pixel
    x - d (the right census edge-padded: columns x < d see column 0)."""
    h, w, _ = census_l.shape
    dev = census_l.device
    cl, cr = _pack(census_l), _pack(census_r)
    xs = torch.arange(w, device=dev)[:, None] - torch.arange(max_disp, device=dev)[None, :]
    shifted = cr[:, xs.clamp(min=0)]                      # (H,W,D)
    return _popcount(cl[:, :, None] ^ shifted).to(torch.float32)


def _path_segments(c: torch.Tensor, tile: int, halo: int):
    """(S,T,D) -> (halo + tile, n_tiles*T, D) path segments: each tile of
    ``tile`` path pixels preceded by ``halo`` warm-up pixels, clamped at
    the border."""
    S, T, D = c.shape
    n_tiles = -(-S // tile)
    idx = (torch.arange(n_tiles, device=c.device)[:, None] * tile
           + torch.arange(-halo, tile, device=c.device)[None, :]).clamp(0, S - 1)
    seg = c[idx]                                           # (n_tiles, L, T, D)
    return seg.movedim(1, 0).reshape(halo + tile, n_tiles * T, D), n_tiles


def _segments_to_image(agg: torch.Tensor, n_tiles: int, S: int, T: int) -> torch.Tensor:
    """(tile, n_tiles*T, D) tile outputs -> (S,T,D)."""
    tile, _, D = agg.shape
    out = agg.reshape(tile, n_tiles, T, D).movedim(1, 0).reshape(n_tiles * tile, T, D)
    return out[:S]


def _aggregate_4dir(vol: torch.Tensor, p1: float, p2: float, tile: int,
                    halo: int) -> torch.Tensor:
    """Sum of the 4 directions' SGM path costs, all tiles of all directions
    advanced together in ``halo + tile - 1`` steps."""
    big = 1e9
    cols = vol                                  # scan over rows (axis 0)
    rows = vol.movedim(1, 0)                    # scan over columns
    views = [rows, rows.flip(0), cols, cols.flip(0)]
    segs, meta = [], []
    for v in views:
        seg, n_tiles = _path_segments(v, tile, halo)
        segs.append(seg)
        meta.append((n_tiles, v.shape[0], v.shape[1], seg.shape[1]))
    batch = torch.cat(segs, dim=1)              # (L, sum of batches, D)

    pad_big = batch.new_full(batch.shape[1:-1] + (1,), big)
    prev = batch[0]
    outs = [prev]
    for cur in batch[1:]:
        prev_min = prev.amin(dim=-1, keepdim=True)
        shift_p = torch.cat([pad_big, prev[..., :-1]], dim=-1)
        shift_n = torch.cat([prev[..., 1:], pad_big], dim=-1)
        smooth = torch.minimum(torch.minimum(prev, torch.minimum(shift_p, shift_n) + p1),
                               prev_min + p2)
        prev = cur + smooth - prev_min
        outs.append(prev)
    agg = torch.stack(outs[halo:], dim=0)       # (tile, B, D)

    total = torch.zeros_like(vol)
    off = 0
    for i, (n_tiles, S, T, width) in enumerate(meta):
        img = _segments_to_image(agg[:, off:off + width], n_tiles, S, T)
        off += width
        if i in (1, 3):
            img = img.flip(0)
        if i in (0, 1):
            img = img.movedim(1, 0)
        total = total + img
    return total


def sgm_disparity(img_l: torch.Tensor, img_r: torch.Tensor, max_disp: int = 64,
                  p1: float = 8.0, p2: float = 64.0, census_radius: int = 2,
                  lr_tolerance: float = 1.5, uniqueness: float = 0.95,
                  path_tile: int = 32, path_halo: int = 16) -> torch.Tensor:
    """(H,W) float32 left disparity with sub-pixel refinement and LR check;
    invalid pixels are -1."""
    vol = cost_volume(census_transform(img_l, census_radius),
                      census_transform(img_r, census_radius), max_disp)
    agg = _aggregate_4dir(vol, p1, p2, path_tile, path_halo)
    D = max_disp
    dev = agg.device

    c_best = agg.amin(dim=-1)
    d_best = agg.argmin(dim=-1)                 # first index of a tie

    # uniqueness: the best must beat the second best outside +-1 by the ratio
    dd = torch.arange(D, device=dev)
    near = (dd[None, None, :] - d_best[..., None]).abs() <= 1
    c_second = torch.where(near, agg.new_full((), 1e9), agg).amin(dim=-1)
    unique_ok = c_best <= uniqueness * c_second

    # parabola sub-pixel
    d0 = d_best.clamp(1, D - 2)
    cm = agg.gather(-1, (d0 - 1)[..., None])[..., 0]
    cc = agg.gather(-1, d0[..., None])[..., 0]
    cp = agg.gather(-1, (d0 + 1)[..., None])[..., 0]
    denom = torch.clamp(cm - 2 * cc + cp, min=1e-6)
    offset = torch.clamp((cm - cp) / (2 * denom), -0.5, 0.5)
    inner = (d_best >= 1) & (d_best <= D - 2)
    disp = d_best.to(torch.float32) + torch.where(inner, offset, offset.new_zeros(()))

    # right disparity by reprojecting the cost volume: cost_r(x, d) =
    # cost_l(x + d, d), edge-padded at the right border
    h, w = img_l.shape
    xs = torch.arange(w, device=dev)
    src = (xs[:, None] + dd[None, :]).clamp(max=w - 1)     # (W,D)
    agg_r = agg.gather(1, src[None].expand(h, w, D))
    d_right = agg_r.argmin(dim=-1)
    # check |d_l(x) - d_r(x - d_l(x))| <= tol
    xr = (xs[None, :] - d_best).clamp(0, w - 1)
    d_r_at = d_right.gather(1, xr)
    lr_ok = (d_best - d_r_at).abs() <= lr_tolerance

    valid = unique_ok & lr_ok & (d_best > 0)
    return torch.where(valid, disp, disp.new_full((), INVALID))
