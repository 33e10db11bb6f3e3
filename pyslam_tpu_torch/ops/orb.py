"""Oriented BRIEF descriptors + intensity-centroid orientation (port of
``pyslam_tpu/ops/orb.py:41-214``).

The sampling pattern is generated from the same numpy seed, so it equals the
reference's.  Descriptors are unpacked 0/1 bit-planes, (N, 256) int8.

``brief_from_patches`` compares the two pattern pixels of each bit directly
(a gather and a ``<``).  The reference writes the same comparison as one
matmul per angle bin with a {+1, -1} selection matrix, ``(b - a) > 0``; for
finite float32 values that test equals ``a < b``, so the bits are identical.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

PATCH_RADIUS = 15
MOMENT_RADIUS = 7        # orientation patch (smaller than the descriptor's)
PATTERN_RADIUS = 10      # max pattern offset: stays inside the patch rotated
NUM_BITS = 256
ANGLE_BINS = 30          # rBRIEF quantisation: 12 degrees
PATCH_SIZE = 32
PATCH_HALF = 16


def _make_pattern(seed: int = 20240618) -> np.ndarray:
    """(256, 4) int8 pattern rows (x1, y1, x2, y2), Gaussian G-II sampling."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_RADIUS * 2 / 5.0
    pts = rng.normal(0.0, sigma, size=(NUM_BITS, 4))
    pts = np.clip(np.round(pts), -PATTERN_RADIUS, PATTERN_RADIUS)
    return pts.astype(np.int8)


PATTERN = _make_pattern()


def _moment_kernels() -> tuple[np.ndarray, np.ndarray]:
    """(32, 32) x/y moment weights on the MOMENT_RADIUS circle around the
    patch centre [16, 16]."""
    r = MOMENT_RADIUS
    ys, xs = np.mgrid[0:32, 0:32]
    dx = xs - 16
    dy = ys - 16
    mask = (dx * dx + dy * dy) <= r * r
    return (dx * mask).astype(np.float32), (dy * mask).astype(np.float32)


def _binned_pattern_indices() -> tuple[np.ndarray, np.ndarray]:
    """(ANGLE_BINS, 256) flat patch indices of each rotated pattern point."""
    p = PATTERN.astype(np.float32)
    out1 = np.zeros((ANGLE_BINS, NUM_BITS), np.int64)
    out2 = np.zeros((ANGLE_BINS, NUM_BITS), np.int64)
    for b in range(ANGLE_BINS):
        th = 2.0 * np.pi * b / ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for which, out in ((0, out1), (2, out2)):
            px, py = p[:, which], p[:, which + 1]
            rx = np.clip(np.round(c * px - s * py), -(PATCH_HALF - 1), PATCH_HALF - 1)
            ry = np.clip(np.round(s * px + c * py), -(PATCH_HALF - 1), PATCH_HALF - 1)
            out[b] = ((ry + PATCH_HALF) * PATCH_SIZE + (rx + PATCH_HALF)).astype(np.int64)
    return out1, out2


_BIN_IDX1, _BIN_IDX2 = _binned_pattern_indices()
_MOM_KX, _MOM_KY = _moment_kernels()


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device):
    """Per-device copies of the constant tables."""
    return (torch.from_numpy(_MOM_KX).to(device), torch.from_numpy(_MOM_KY).to(device),
            torch.from_numpy(_BIN_IDX1).to(device), torch.from_numpy(_BIN_IDX2).to(device))


def extract_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, H, W) images, (B, N, 2) keypoints -> (B, N, 32, 32) patches
    centred (at [16, 16]) on the rounded keypoint, clamped into the image."""
    b, h, w = img.shape
    x0 = torch.clamp(torch.round(xy[..., 0]).to(torch.int64) - PATCH_HALF, 0, w - PATCH_SIZE)
    y0 = torch.clamp(torch.round(xy[..., 1]).to(torch.int64) - PATCH_HALF, 0, h - PATCH_SIZE)
    off = torch.arange(PATCH_SIZE, device=img.device)
    rows = y0[..., None, None] + off[:, None]                  # (B, N, 32, 1)
    cols = x0[..., None, None] + off[None, :]                  # (B, N, 1, 32)
    flat_idx = rows * w + cols                                 # (B, N, 32, 32)
    n = xy.shape[1]
    out = torch.gather(img.reshape(b, 1, h * w).expand(b, n, h * w), 2,
                       flat_idx.reshape(b, n, -1))
    return out.reshape(b, n, PATCH_SIZE, PATCH_SIZE)


def angles_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle of (..., 32, 32) patches, quantised to
    ANGLE_BINS bins (radians)."""
    kx, ky, _, _ = _device_tables(patches.device)
    p = patches.to(torch.float64)
    # float64 moments are exact (products of float32 values and small
    # integers, summed over 1024 terms, fit in 53 bits), so the angle bin
    # does not depend on the device's summation order
    m10 = torch.sum(p * kx.to(torch.float64), dim=(-2, -1))
    m01 = torch.sum(p * ky.to(torch.float64), dim=(-2, -1))
    angle = torch.atan2(m01, m10)
    step = 2.0 * math.pi / ANGLE_BINS
    return (torch.round(angle / step) * step).to(patches.dtype)


def angle_bins(angles: torch.Tensor) -> torch.Tensor:
    """Quantised-angle bin ids in [0, ANGLE_BINS)."""
    step = 2.0 * math.pi / ANGLE_BINS
    return torch.remainder(torch.round(angles / step).to(torch.int64), ANGLE_BINS)


def brief_from_patches(patches: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """(..., N, 32, 32) patches + (..., N) bin ids -> (..., N, 256) int8 bits:
    bit k is patch[idx1[bin, k]] < patch[idx2[bin, k]]."""
    _, _, i1, i2 = _device_tables(patches.device)
    flat = patches.reshape(*patches.shape[:-2], PATCH_SIZE * PATCH_SIZE)
    a = torch.gather(flat, -1, i1[bins])
    b = torch.gather(flat, -1, i2[bins])
    return (a < b).to(torch.int8)
