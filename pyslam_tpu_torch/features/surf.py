"""SURF: box-filter Hessian detector and Haar descriptor (port of
``pyslam_tpu/features/surf.py``).

  * detector: det(H) = Dxx*Dyy - (0.9*Dxy)^2 from 9/15/21/27-px box
    approximations of the Gaussian second derivatives, each box 4 taps into
    one integral image; grid top-k over the maximum across scales;
  * orientation: the direction of the summed Haar responses on a ring;
  * descriptor: 4x4 subregions of a 20s x 20s oriented grid, each
    contributing (sum dx, sum |dx|, sum dy, sum |dy|) -> 64 floats,
    L2-normalised.

The integral image is summed in the reference's order
(``image.integral_image``) and the responses are rounded as its compiled
CPU code rounds them (the fused multiply-adds and the folded constants of
``_hessian_det``), so the responses and the detector's keypoints are the
reference's bit for bit; the orientation and descriptor
go through the device's trigonometry and agree to float32 noise.
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.features.orb2 import FeatureData
from pyslam_tpu_torch.ops import image as image_ops
from pyslam_tpu_torch.ops import nms as nms_ops
from pyslam_tpu_torch.ops.voxel_hash import fma32

_LOBES = (9, 15, 21, 27)     # box filter sizes (first octave, SURF paper)
_INV_255 = float(np.float32(1.0 / 255.0))   # XLA's reciprocal of a constant divisor


def _box(ii: torch.Tensor, y1, x1, y2, x2):
    """Sum over [y1, y2) x [x1, x2) with clamped integer corners."""
    hh = ii.shape[0] - 1
    ww = ii.shape[1] - 1
    flat = ii.reshape(-1)
    wi = ww + 1
    y1 = torch.clamp(y1, 0, hh)
    y2 = torch.clamp(y2, 0, hh)
    x1 = torch.clamp(x1, 0, ww)
    x2 = torch.clamp(x2, 0, ww)
    return (flat[y2 * wi + x2] - flat[y1 * wi + x2]) - flat[y2 * wi + x1] + flat[y1 * wi + x1]


def _hessian_det(ii, L: int, ys, xs):
    """det(H) response of the L-px box filter at integer (ys, xs)."""
    l3 = L // 3
    h3 = l3 // 2
    half = L // 2
    norm = float(np.float32(1.0 / (L * L)))
    w = 2 * l3 - 1
    neg3 = torch.tensor(-3.0, dtype=torch.float32, device=ii.device)
    dyy = fma32(neg3, _box(ii, ys - h3, xs - w // 2, ys + h3 + 1, xs + w // 2 + 1),
                _box(ii, ys - half, xs - w // 2, ys + half + 1, xs + w // 2 + 1))
    dxx = fma32(neg3, _box(ii, ys - w // 2, xs - h3, ys + w // 2 + 1, xs + h3 + 1),
                _box(ii, ys - w // 2, xs - half, ys + w // 2 + 1, xs + half + 1))
    dxy = (_box(ii, ys - l3, xs + 1, ys, xs + l3 + 1)
           + _box(ii, ys + 1, xs - l3, ys + l3 + 1, xs)
           - _box(ii, ys - l3, xs - l3, ys, xs)
           - _box(ii, ys + 1, xs + 1, ys + l3 + 1, xs + l3 + 1))
    dxx = dxx * norm
    dyy = dyy * norm
    # XLA folds 0.9 * (dxy * norm) into one float32 constant factor
    t = dxy * float(np.float32(0.9) * np.float32(norm))
    return fma32(dxx, dyy, -(t * t))


def _haar(ii, ys, xs, s):
    """Haar dx, dy responses (box side 2s) at float coordinates (truncated)."""
    yi = ys.to(torch.int64)
    xi = xs.to(torch.int64)
    si = torch.clamp(s.to(torch.int64), min=1)
    dx = _box(ii, yi - si, xi, yi + si, xi + si) - _box(ii, yi - si, xi - si, yi + si, xi)
    dy = _box(ii, yi, xi - si, yi + si, xi + si) - _box(ii, yi - si, xi - si, yi, xi + si)
    return dx, dy


def _segment_cells(val: torch.Tensor) -> torch.Tensor:
    """(N, 400) samples of the 20x20 grid -> (N, 16) sums over its 4x4
    cells of 5x5 samples, each in sample order."""
    n = val.shape[0]
    v = val.reshape(n, 4, 5, 4, 5).permute(0, 1, 3, 2, 4).reshape(n, 16, 25)
    acc = v[..., 0]
    for i in range(1, 25):
        acc = acc + v[..., i]
    return acc


class SurfExtractor:
    """SURF keypoints + 64-d descriptors with the FeatureData contract, on
    ``device`` (the card unless the caller asks for another)."""

    def __init__(self, num_features: int = 1000, nms_cell: int = 8, *,
                 device: torch.device | str = "cuda"):
        self.num_features = num_features
        self.nms_cell = nms_cell
        self.device = torch.device(device)
        self.scale_factors = np.array([1.0], np.float32)
        self.sigma2 = np.array([1.0], np.float32)
        self.inv_sigma2 = 1.0 / self.sigma2
        # the keypoint scale 1.2 * L / 9 of each lobe, rounded as the
        # reference computes it (float32, the division as a reciprocal)
        self._lobe_scale = (np.float32(1.2) * np.asarray(_LOBES, np.float32)
                            * np.float32(1.0 / 9.0)).astype(np.float32)

    def extract(self, img: torch.Tensor) -> FeatureData:
        """(H, W) float32 image on the device -> FeatureData."""
        dev = img.device
        h, w = img.shape
        n = self.num_features
        ii = image_ops.integral_image(img * _INV_255)
        ys = torch.arange(h, device=dev)[:, None].expand(h, w)
        xs = torch.arange(w, device=dev)[None, :].expand(h, w)
        responses = torch.stack([_hessian_det(ii, L, ys, xs) for L in _LOBES])
        best = responses.amax(0)
        lobe = torch.argmax(responses, 0)   # first lobe on ties, as the reference
        xy, resp, valid = nms_ops.grid_topk_keypoints(best[None], cell=self.nms_cell,
                                                      per_cell=4, max_out=n)
        xy, resp, valid = xy[0], resp[0], valid[0]
        xi = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1)
        yi = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1)
        scale = torch.as_tensor(self._lobe_scale, device=dev)[lobe[yi, xi]]
        x, y = xy[:, 0], xy[:, 1]

        # orientation: vector sum of Haar responses on a ring of radius 4s
        ang = torch.arange(12, dtype=torch.float32, device=dev) * float(
            np.float32(2 * np.pi / 12))
        rx = x[:, None] + (4.0 * scale)[:, None] * torch.cos(ang)[None]
        ry = y[:, None] + (4.0 * scale)[:, None] * torch.sin(ang)[None]
        dx, dy = _haar(ii, ry, rx, (2.0 * scale)[:, None].expand(-1, 12))
        angs = torch.atan2(dy.sum(1), dx.sum(1))

        # descriptor: 4x4 cells x 5x5 samples of an oriented Haar grid
        gi = (torch.arange(20, dtype=torch.float32, device=dev) - 9.5) / 20.0
        v, u = torch.meshgrid(gi, gi, indexing="ij")
        u = u.reshape(-1)[None]
        v = v.reshape(-1)[None]
        cos = torch.cos(angs)[:, None]
        sin = torch.sin(angs)[:, None]
        s = scale[:, None]
        px = x[:, None] + (cos * u - sin * v) * 20.0 * s
        py = y[:, None] + (sin * u + cos * v) * 20.0 * s
        hdx, hdy = _haar(ii, py, px, s.expand(-1, 400))
        rdx = cos * hdx + sin * hdy
        rdy = -sin * hdx + cos * hdy
        feats = torch.stack([_segment_cells(rdx), _segment_cells(rdx.abs()),
                             _segment_cells(rdy), _segment_cells(rdy.abs())], 2).reshape(n, 64)
        desc = feats / torch.clamp(torch.linalg.norm(feats, dim=1, keepdim=True), min=1e-9)
        return FeatureData(
            xy=xy, level=torch.zeros(n, dtype=torch.int64, device=dev),
            angle=torch.remainder(torch.rad2deg(angs), 360.0), size=2.0 * scale * 9.0,
            response=resp, desc=desc, valid=valid)

    def __call__(self, img) -> FeatureData:
        """(H, W) grey (or (H, W, 3)) image -> FeatureData on ``device``."""
        return self.extract(image_ops.gray_image(img, self.device))
