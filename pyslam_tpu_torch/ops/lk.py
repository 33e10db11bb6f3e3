"""Pyramidal Lucas-Kanade optical flow (port of ``pyslam_tpu/ops/lk.py``).

Every point advances in parallel: on each level, coarse to fine, a fixed
number of Gauss-Newton iterations solve the 2x2 flow system of a 15x15
patch from bilinear samples of the template, its Sobel gradients and the
target image (batched gathers and row sums).  The reference has no Pallas
kernel here; this is plain PyTorch, about 40 small launches an iteration.
"""

from __future__ import annotations

import torch

from pyslam_tpu_torch.ops import image as image_ops


def _patch_offsets(radius: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def lk_flow_level(img0: torch.Tensor, img1: torch.Tensor, pts0: torch.Tensor,
                  guess: torch.Tensor, radius: int = 7, iters: int = 8):
    """One level: track (N, 2) pts0 from img0 to img1 starting at guess.
    Returns (points (N, 2), ok (N,): a well-conditioned system (det > 1e-4)
    and the result inside the image by ``radius``, mean absolute residual
    (N,))."""
    ox, oy = _patch_offsets(radius, img0.device)
    gx0, gy0 = image_ops.sobel_gradients(img0)

    def sample(img, xy):
        return image_ops.bilinear_sample(
            img, torch.stack([xy[:, 0:1] + ox[None, :], xy[:, 1:2] + oy[None, :]], -1))

    t0 = sample(img0, pts0)                      # template (N, P)
    Ix = sample(gx0, pts0) / 8.0                 # Sobel scale
    Iy = sample(gy0, pts0) / 8.0
    A11 = torch.sum(Ix * Ix, 1)
    A12 = torch.sum(Ix * Iy, 1)
    A22 = torch.sum(Iy * Iy, 1)
    det = A11 * A22 - A12 * A12
    good = det > 1e-4
    det_s = torch.where(good, det, torch.ones_like(det))
    cur = guess
    for _ in range(iters):
        e = sample(img1, cur) - t0
        b1 = torch.sum(Ix * e, 1)
        b2 = torch.sum(Iy * e, 1)
        du = -(A22 * b1 - A12 * b2) / det_s
        dv = -(-A12 * b1 + A11 * b2) / det_s
        step = torch.clamp(torch.stack([du, dv], 1), -radius, radius)
        cur = cur + torch.where(good[:, None], step, torch.zeros_like(step))
    res = torch.mean(torch.abs(sample(img1, cur) - t0), 1)
    h, w = img0.shape
    inside = ((cur[:, 0] > radius) & (cur[:, 0] < w - radius)
              & (cur[:, 1] > radius) & (cur[:, 1] < h - radius))
    return cur, good & inside, res


def lk_track_pyramidal(img0: torch.Tensor, img1: torch.Tensor, pts0: torch.Tensor,
                       num_levels: int = 3, radius: int = 7, iters: int = 8):
    """Coarse-to-fine LK of (N, 2) points between two (H, W) float32 images
    over a ``num_levels`` pyramid at scale 2.  Returns (points (N, 2), ok
    (N,), residuals (N,) of the finest level)."""
    pyr0 = image_ops.build_pyramid(img0, num_levels, 2.0)
    pyr1 = image_ops.build_pyramid(img1, num_levels, 2.0)
    guess = pts0 / 2.0 ** (num_levels - 1)
    ok = torch.ones(pts0.shape[0], dtype=torch.bool, device=pts0.device)
    res = None
    for lv in range(num_levels - 1, -1, -1):
        out, ok_lv, res = lk_flow_level(pyr0[lv], pyr1[lv], pts0 / 2.0 ** lv, guess,
                                        radius, iters)
        ok = ok & ok_lv
        guess = out * 2.0 if lv > 0 else out
    return guess, ok, res
