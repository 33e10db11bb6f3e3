"""Differentiable tile-based 3D Gaussian splatting rasterizer (port of
``pyslam_tpu/ops/gaussian_splatting.py``).

- Fixed capacity: N gaussian slots with a validity mask; the integrator
  seeds free slots between optimisation rounds.
- EWA projection: the 3D covariance R(q) S Sᵀ R(q)ᵀ through the
  perspective Jacobian to a 2D conic per gaussian, with a 0.3 px low-pass
  and a 3-sigma screen radius.
- Tiles of 16x16 pixels, each with a static top-k of the gaussians by
  tile-overlap score (the distance from the tile's centre to the
  gaussian's minus its radius and the tile's half diagonal).  The
  selection is not differentiable and runs without autograd, in chunks of
  tiles; it keeps ``jax.lax.top_k``'s order: scores descending, equal
  scores by ascending index (``tile_topk``).  Each tile's k sort by depth
  (stable), and each pixel composites them front to back with an
  exclusive cumprod of the transmittance.
- ``optimize_gaussians``: ``steps`` Adam updates (optax's ``adam``: b1 0.9,
  b2 0.999, eps 1e-8 outside the square root, the step count carried in
  ``AdamState``; ``ops/adam.py``, shared with the trainers) of the mean
  loss over a window of views, L1 colour plus 0.1 x L1 depth.  The
  leaves are updated in place, so the integrator's inserts keep the
  moments.

Plain PyTorch with autograd: the JAX package's rasterizer is XLA ops
outside any Pallas kernel.  ``seed_from_depth`` stays host numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyslam_tpu_torch.ops import adam
from pyslam_tpu_torch.ops.adam import AdamState

TILE = 16
TRAINABLE = ("means", "log_scales", "quats", "opacity_logit", "colors")
# elements of the (tiles, gaussians) score matrix per selection chunk
SELECT_CHUNK = 1 << 27


class Gaussians(NamedTuple):
    means: torch.Tensor          # (N, 3) world
    log_scales: torch.Tensor     # (N, 3)
    quats: torch.Tensor          # (N, 4) wxyz (normalised in the graph)
    opacity_logit: torch.Tensor  # (N,)
    colors: torch.Tensor         # (N, C) raw
    valid: torch.Tensor          # (N,) bool


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-9)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def project_gaussians(g: Gaussians, Tcw: torch.Tensor, K: torch.Tensor):
    """World gaussians -> per gaussian 2D mean (N, 2), conic (N, 3) (a, b, c
    of the inverse 2D covariance), depth, screen radius, alpha and whether
    it is valid and in front of the camera."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pc = g.means @ R.T + t
    z = torch.clamp(pc[:, 2], min=1e-6)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    mean2d = torch.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], 1)

    Rq = quat_to_rot(g.quats)
    M = Rq * torch.exp(g.log_scales)[:, None, :]           # R diag(S)
    cov3d_c = R @ (M @ M.transpose(1, 2)) @ R.T            # camera frame
    x_, y_ = pc[:, 0], pc[:, 1]
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / z, zero, -fx * x_ / (z * z)], -1),
                     torch.stack([zero, fy / z, -fy * y_ / (z * z)], -1)], 1)   # (N, 2, 3)
    cov2d = J @ cov3d_c @ J.transpose(1, 2)
    ok = (pc[:, 2] > 0.05) & g.valid
    # behind the camera z is clamped and the covariance can overflow; such a
    # gaussian is never composited, and a finite stand-in keeps its gradient
    # at zero, as the reference's is, where inf - inf would make it NaN
    cov2d = torch.where(ok[:, None, None], cov2d, torch.zeros_like(cov2d))
    cov2d = cov2d + 0.3 * torch.eye(2, dtype=cov2d.dtype, device=cov2d.device)

    det = torch.clamp(cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0],
                      min=1e-9)
    conic = torch.stack([cov2d[:, 1, 1], -cov2d[:, 0, 1], cov2d[:, 0, 0]], 1) / det[:, None]
    radius = 3.0 * torch.sqrt(torch.clamp(torch.maximum(cov2d[:, 0, 0], cov2d[:, 1, 1]),
                                          min=1e-9))
    alpha = torch.sigmoid(g.opacity_logit)
    return mean2d, conic, z, radius, alpha, ok


def tile_centers(th: int, tw: int, device) -> torch.Tensor:
    """(T, 2) [y, x] centres of the th x tw tiles, row by row."""
    ty = (torch.arange(th, device=device, dtype=torch.float32) + 0.5) * TILE
    tx = (torch.arange(tw, device=device, dtype=torch.float32) + 0.5) * TILE
    return torch.stack(torch.meshgrid(ty, tx, indexing="ij"), -1).reshape(-1, 2)


def tile_scores(cyx, mean2d, radius, ok) -> torch.Tensor:
    """(T, N) overlap score of each tile and gaussian (larger is better,
    -inf for an invalid one)."""
    dy = cyx[:, 0:1] - mean2d[None, :, 1]
    dx = cyx[:, 1:2] - mean2d[None, :, 0]
    margin = torch.sqrt(dx * dx + dy * dy) - radius[None, :] - (TILE * 0.7071)
    return torch.where(ok[None, :], -margin, torch.full_like(margin, float("-inf")))


def tile_topk(score: torch.Tensor, k: int) -> torch.Tensor:
    """(T, N) -> (T, k) int64 indices as ``jax.lax.top_k`` gives them: the
    k largest of each row, scores descending, equal scores by ascending
    index (so which of the tied gaussians at the cut enter is fixed too)."""
    T, n = score.shape
    kth = torch.topk(score, k, dim=1, sorted=False)[0].amin(1, keepdim=True)
    greater = score > kth
    equal = score == kth
    need = k - greater.sum(1, keepdim=True)
    take = greater | (equal & (torch.cumsum(equal, 1) <= need))     # k a row
    pos = torch.where(take, torch.cumsum(take, 1) - 1, k)           # slot k collects the rest
    out = torch.zeros((T, k + 1), dtype=torch.int64, device=score.device)
    out.scatter_(1, pos, torch.arange(n, device=score.device).expand(T, n))
    idx = out[:, :k]                                                # ascending index
    order = torch.sort(torch.gather(score, 1, idx), dim=1, descending=True, stable=True)[1]
    return torch.gather(idx, 1, order)


def select_tiles(cyx, mean2d, radius, ok, k: int):
    """Each tile's top-k gaussians (T, k) and whether each holds a valid
    one (T, k), without autograd, ``SELECT_CHUNK`` score elements at a
    time."""
    with torch.no_grad():
        mean2d, radius = mean2d.detach(), radius.detach()
        step = max(1, SELECT_CHUNK // max(mean2d.shape[0], 1))
        idx, sel_ok = [], []
        for s in range(0, cyx.shape[0], step):
            score = tile_scores(cyx[s:s + step], mean2d, radius, ok)
            i = tile_topk(score, k)
            idx.append(i)
            sel_ok.append(torch.gather(score, 1, i) > -1e30)
        return torch.cat(idx), torch.cat(sel_ok)


def _untile(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(T, P, ...) per-tile pixels -> (h, w, ...)."""
    rest = x.shape[2:]
    x = x.reshape(th, tw, TILE, TILE, *rest).transpose(1, 2)
    return x.reshape(th * TILE, tw * TILE, *rest)


def rasterize(g: Gaussians, Tcw: torch.Tensor, K: torch.Tensor, h: int, w: int, k: int = 64,
              return_indices: bool = False):
    """Render (h, w, C) colour, (h, w) alpha and (h, w) expected depth (not
    divided by alpha).  ``return_indices`` also returns each tile's k
    gaussians in depth order (T, k) and their validity."""
    mean2d, conic, depth, radius, alpha, ok = project_gaussians(g, Tcw, K)
    th, tw = h // TILE, w // TILE
    cyx = tile_centers(th, tw, mean2d.device)
    idx, sel_ok = select_tiles(cyx, mean2d, radius, ok, k)

    # each tile's k by depth, front first (stable: equal depths keep the
    # selection's order)
    with torch.no_grad():
        inf = torch.full((), float("inf"), device=depth.device)
        order = torch.argsort(torch.where(sel_ok, depth.detach()[idx], inf), dim=1, stable=True)
        idx = torch.gather(idx, 1, order)
        sel_ok = torch.gather(sel_ok, 1, order)
    m2, cn, dp, al, cl = mean2d[idx], conic[idx], depth[idx], alpha[idx], g.colors[idx]

    # per-pixel compositing
    off = torch.arange(TILE, device=cyx.device, dtype=torch.float32)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    pix = torch.stack([oy, ox], -1).reshape(-1, 2)                      # (P, 2)
    pyx = (cyx - TILE * 0.5)[:, None, :] + pix[None] + 0.5              # (T, P, 2)
    d_y = pyx[:, :, 0:1] - m2[:, None, :, 1]                            # (T, P, K)
    d_x = pyx[:, :, 1:2] - m2[:, None, :, 0]
    a, b, c = cn[:, None, :, 0], cn[:, None, :, 1], cn[:, None, :, 2]
    power = -0.5 * (a * d_x * d_x + 2.0 * b * d_x * d_y + c * d_y * d_y)
    gval = torch.exp(torch.clamp(power, max=0.0))
    a_pix = torch.clamp(al[:, None, :] * gval, 0.0, 0.999)
    a_pix = torch.where(sel_ok[:, None, :], a_pix, torch.zeros_like(a_pix))
    trans = torch.cumprod(1.0 - a_pix + 1e-10, 2)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], 2)
    wgt = a_pix * trans                                                 # (T, P, K)

    color = _untile(wgt @ cl, th, tw)
    acc = _untile(wgt.sum(2), th, tw)
    depth_img = _untile((wgt @ dp[..., None])[..., 0], th, tw)
    if return_indices:
        return color, acc, depth_img, idx, sel_ok
    return color, acc, depth_img


# ------------------------------------------------------------------ training
def render_loss(g: Gaussians, Tcw, K, target, target_depth, h, w, k, depth_weight=0.1):
    color, acc, depth_img = rasterize(g, Tcw, K, h, w, k)
    loss = torch.mean(torch.abs(color - target))
    if target_depth is not None:
        dmask = (target_depth > 0) & (acc > 0.5)
        err = torch.abs(depth_img / torch.clamp(acc, min=1e-6) - target_depth)
        dl = torch.sum(torch.where(dmask, err, torch.zeros_like(err))) / torch.clamp(
            dmask.sum().to(err.dtype), min=1.0)
        loss = loss + depth_weight * dl
    return loss


def trainable(g: Gaussians) -> dict:
    return {name: getattr(g, name) for name in TRAINABLE}


def optimize_gaussians(g: Gaussians, opt_state: AdamState | None, Tcws, Ks, targets,
                       target_depths, h: int, w: int, k: int, steps: int, lr: float = 5e-3):
    """``steps`` Adam updates of the mean ``render_loss`` over the views
    (Tcws (B, 4, 4), targets (B, h, w, C), target_depths (B, h, w) or
    zeros), one K for all.  The trainable leaves of ``g`` are updated in
    place.  Returns (g, opt_state, losses (steps,)), the loss before each
    update."""
    params = trainable(g)
    if opt_state is None:
        opt_state = adam.init_state(params)
    for p in params.values():
        p.requires_grad_(True)
    B = Tcws.shape[0]
    losses = []
    for _ in range(steps):
        for p in params.values():
            p.grad = None
        total = torch.zeros((), device=Tcws.device)
        for v in range(B):
            loss = render_loss(g, Tcws[v], Ks, targets[v], target_depths[v], h, w, k) / B
            loss.backward()
            total = total + loss.detach()
        losses.append(total)
        adam.adam_step_(params, {n: p.grad for n, p in params.items()}, opt_state, lr)
    for p in params.values():
        p.grad = None
        p.requires_grad_(False)
    return g, opt_state, torch.stack(losses)


def seed_from_depth(depth: np.ndarray, intensity: np.ndarray, Twc: np.ndarray, K: np.ndarray,
                    stride: int = 4, max_depth: float = 1e9) -> dict:
    """Backproject a keyframe into seed gaussians (host): positions from
    depth, an isotropic scale from the pixel footprint, colour from the
    intensity."""
    h, w = depth.shape
    ys, xs = np.mgrid[stride // 2: h: stride, stride // 2: w: stride]
    ys, xs = ys.ravel(), xs.ravel()
    z = depth[ys, xs]
    ok = (z > 0) & (z < max_depth) & np.isfinite(z)
    ys, xs, z = ys[ok], xs[ok], z[ok]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pc = np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], axis=1)
    pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
    # footprint: stride pixels at depth z
    scale = np.log(np.maximum(z * stride / fx, 1e-4))
    col = intensity[ys, xs].astype(np.float32)
    if col.ndim == 1:
        col = col[:, None]
    col = col / 255.0
    n = len(pw)
    return {
        "means": pw.astype(np.float32),
        "log_scales": np.tile(scale[:, None], (1, 3)).astype(np.float32),
        "quats": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "opacity_logit": np.full((n,), 1.0, np.float32),  # sigmoid ~ 0.73
        "colors": col,
    }
