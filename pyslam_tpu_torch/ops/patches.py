"""Oriented keypoint-patch sampling (port of ``pyslam_tpu/ops/patches.py``).

All N patches of a frame come from one batched bilinear gather.  The affine
convention is the reference's (a dst->src map, ``cv2.WARP_INVERSE_MAP``):
for patch pixel (u, v) of a ``patch_size``² grid,

    scale = mag_factor * kp.size / patch_size
    src_x = scale*cos*(u - h) - scale*sin*(v - h) + kp.x
    src_y = scale*sin*(u - h) + scale*cos*(v - h) + kp.y     (h = patch_size/2)

with (cos, sin) = (1, 0) for a keypoint without orientation (angle < 0).

Rounding follows the reference's compiled CPU code, which contracts the
sample's blend and the grid's rotation into fused multiply-adds
(``fma32``, emulated in float64: the same bits on the CPU and the card).
The trigonometric functions are the device's own, so oriented patches agree
with the reference only to float32 noise of the angle.
"""

from __future__ import annotations

import math

import torch

from pyslam_tpu_torch.ops.voxel_hash import fma32


def _bilinear_gather(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                     level: torch.Tensor | None = None) -> torch.Tensor:
    """Sample a (H, W) image at float coordinates of any shape; taps
    outside the image read 0 (``WARP_FILL_OUTLIERS``).  With ``level`` (an
    integer tensor broadcastable to the coordinates) ``img`` is a (S, H, W)
    stack and each sample reads its own level.  The blend is rounded as XLA
    contracts it: fma(v11 fx, fy, fma(v10 gx, fy, fma(v00 gx, gy, v01 fx
    gy))) with gx = 1 - fx, gy = 1 - fy."""
    h, w = img.shape[-2:]
    base = 0 if level is None else level * (h * w)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(-1)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = flat[base + torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)]
        return torch.where(inside, v, zero)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    gx = 1 - fx
    gy = 1 - fy
    acc = fma32(v00 * gx, gy, v01 * fx * gy)
    acc = fma32(v10 * gx, fy, acc)
    return fma32(v11 * fx, fy, acc)


def extract_oriented_patches(img: torch.Tensor, xys: torch.Tensor, sizes: torch.Tensor,
                             angles_deg: torch.Tensor, patch_size: int = 32,
                             mag_factor: float = 1.0) -> torch.Tensor:
    """(H, W) image, (N, 2) centres, (N,) diameters (cv2 ``kp.size``), (N,)
    orientations in degrees (negative: unoriented) -> (N, P, P) float32
    patches.  ``mag_factor`` magnifies the keypoint scale (1 for HardNet
    and L2Net, 3 for TFeat and SOSNet in the reference wrappers)."""
    img = img.to(torch.float32)
    dev = img.device
    half = 0.5 * patch_size
    scale = mag_factor * sizes.to(torch.float32) / patch_size
    a_rad = angles_deg.to(torch.float32) * (math.pi / 180.0)
    oriented = a_rad >= 0
    cos = torch.where(oriented, torch.cos(a_rad), torch.ones_like(a_rad)) * scale
    sin = torch.where(oriented, torch.sin(a_rad), torch.zeros_like(a_rad)) * scale
    u = torch.arange(patch_size, dtype=torch.float32, device=dev) - half
    vv, uu = torch.meshgrid(u, u, indexing="ij")       # uu: x index, vv: y index
    c = cos[:, None, None]
    s = sin[:, None, None]
    x = xys[:, 0].to(torch.float32)[:, None, None]
    y = xys[:, 1].to(torch.float32)[:, None, None]
    src_x = fma32(c, uu, -(s * vv)) + x
    src_y = fma32(s, uu, c * vv) + y
    return _bilinear_gather(img, src_x, src_y)


def extract_log_polar_patches(img: torch.Tensor, xys: torch.Tensor, sizes: torch.Tensor,
                              angles_deg: torch.Tensor, patch_size: int = 32,
                              mag_factor: float = 3.0, min_radius: float = 0.7) -> torch.Tensor:
    """Log-polar patches: rows are log-spaced radii (``min_radius`` to
    ``mag_factor * size / 2``), columns angles offset by the keypoint's
    orientation.  Returns (N, P, P) float32."""
    img = img.to(torch.float32)
    dev = img.device
    P = patch_size
    max_r = torch.clamp(mag_factor * sizes.to(torch.float32) * 0.5, min=min_radius + 1e-3)
    angles = angles_deg.to(torch.float32)
    a0 = torch.where(angles >= 0, angles, torch.zeros_like(angles)) * (math.pi / 180.0)
    i = torch.arange(P, dtype=torch.float32, device=dev)
    log_ratio = torch.log(max_r / min_radius)[:, None]
    rho = min_radius * torch.exp(log_ratio * (i[None, :] / (P - 1)))     # (N, P)
    theta = a0[:, None] + 2.0 * math.pi * i[None, :] / P                 # (N, P)
    x = xys[:, 0].to(torch.float32)[:, None, None]
    y = xys[:, 1].to(torch.float32)[:, None, None]
    src_x = x + rho[:, :, None] * torch.cos(theta)[:, None, :]
    src_y = y + rho[:, :, None] * torch.sin(theta)[:, None, :]
    return _bilinear_gather(img, src_x, src_y)
