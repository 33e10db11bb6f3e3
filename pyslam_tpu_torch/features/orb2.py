"""ORB2-class feature extractor: FAST-9 + grid NMS + rBRIEF over a pyramid
(port of ``pyslam_tpu/features/orb2.py:113-229``).

Per image: pyramid, FAST score with 3x3 NMS for every level (one launch of
the CUDA kernel of ``ops.fast.fast_nms_pyramid`` on the card), per-cell
top-k distribution with per-level quotas, orientation and steered BRIEF.
Output shapes are fixed at ``num_features`` slots with a validity mask.  A
stereo pair goes through every stage as one batch of two images, so a
frame costs one kernel launch for all levels of both images; the left/right
row match follows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.ops import fast, hamming, matching, nms, orb
from pyslam_tpu_torch.ops import image as image_ops


class FeatureData(NamedTuple):
    """Fixed-shape extraction result (level-0 coordinates); tensors carry a
    leading batch dimension when a batch was extracted.

    xy (N, 2) float32, level (N,) int64, angle (N,) float32 degrees in
    [0, 360), size (N,) float32, response (N,) float32, desc (N, D): int8
    0/1 bits (256 for ORB2, 486 or 512 for the other binary descriptors)
    or float32 (SIFT, SURF, KAZE), valid (N,) bool.
    """

    xy: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    size: torch.Tensor
    response: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def level_quotas(num_features: int, num_levels: int, scale: float) -> list[int]:
    """Geometric per-level quota (sum == num_features)."""
    inv = 1.0 / scale
    weights = np.array([inv ** l for l in range(num_levels)])
    q = np.floor(num_features * weights / weights.sum()).astype(int)
    q[0] += num_features - q.sum()
    return [int(x) for x in q]


def level_sigma2(num_levels: int, scale: float) -> np.ndarray:
    """Per-level measurement variance (scale^2l)."""
    return np.array([scale ** (2 * l) for l in range(num_levels)], np.float32)


def extract_batch(imgs: torch.Tensor, num_features: int, num_levels: int,
                  scale: float, fast_th: float, cell: int,
                  per_cell: int) -> FeatureData:
    """(B, H, W) float32 images -> FeatureData with (B, N, ...) fields."""
    pyr = image_ops.build_pyramid(imgs, num_levels, scale)
    return extract_pyramid(pyr, num_features, scale, fast_th, cell, per_cell)


def extract_pyramid(pyr: list[torch.Tensor], num_features: int, scale: float,
                    fast_th: float, cell: int, per_cell: int) -> FeatureData:
    """Per-level extraction from a (B, H_l, W_l) pyramid (level l at scale
    ``scale**l``) -> FeatureData with (B, N, ...) fields."""
    b = pyr[0].shape[0]
    num_levels = len(pyr)
    quotas = level_quotas(num_features, num_levels, scale)
    pyr = [p.contiguous() for p in pyr]
    scores = fast.fast_nms_pyramid(pyr, fast_th)   # one kernel launch for all levels
    outs = []
    for lv in range(num_levels):
        quota = quotas[lv]
        if quota == 0:
            continue
        lv_img = pyr[lv]
        score = scores[lv]
        xy, resp, valid = nms.grid_topk_keypoints(score, cell=cell, per_cell=per_cell,
                                                  max_out=quota)
        blurred = image_ops.gaussian_blur(lv_img, sigma=2.0, radius=3)
        patches = orb.extract_patches(blurred, xy)
        angles = orb.angles_from_patches(patches)
        desc = orb.brief_from_patches(patches, orb.angle_bins(angles))
        s = scale ** lv
        outs.append(FeatureData(
            xy=xy * s,
            level=torch.full((b, quota), lv, dtype=torch.int64, device=lv_img.device),
            angle=torch.remainder(angles * (180.0 / math.pi), 360.0),
            size=torch.full((b, quota), 31.0 * s, dtype=torch.float32, device=lv_img.device),
            response=resp.to(torch.float32),
            desc=desc,
            valid=valid,
        ))
    cat = FeatureData(*[torch.cat([getattr(o, f) for o in outs], 1)
                        for f in FeatureData._fields])
    assert cat.xy.shape[1] == num_features
    return cat


def stereo_match(fl: FeatureData, fr: FeatureData, bf: float, max_disp: float,
                 max_distance: float, row_tol: float,
                 distance=hamming.descriptor_distance_matrix):
    """Row-constrained left/right match of one stereo pair; ``distance``
    is the descriptor distance (the matcher's; by default the dtype
    dispatch: Hamming for bits, L2 for floats).

    Returns (ur, depth): per left keypoint the right-image u and the depth,
    -1 where unmatched."""
    d = distance(fl.desc, fr.desc)
    disp = fl.xy[:, 0:1] - fr.xy[None, :, 0]
    idx, _ = matching.row_stereo_match(
        d, fl.xy[:, 1], fr.xy[:, 1], disp, max_distance=max_distance,
        row_tol=row_tol, min_disp=0.1, max_disp=max_disp,
        valid_a=fl.valid, valid_b=fr.valid)
    ok = idx >= 0
    minus1 = torch.full_like(fl.xy[:, 0], -1.0)
    ur = torch.where(ok, fr.xy[torch.clamp(idx, min=0), 0], minus1)
    dsel = torch.where(ok, fl.xy[:, 0] - ur, minus1)
    bf_t = torch.full_like(dsel, bf)
    depth = torch.where(dsel > 0, bf_t / torch.clamp(dsel, min=1e-6), minus1)
    return ur, depth


class ORB2Extractor:
    """Callable extractor with the reference's ORB2 configuration surface.
    ``device`` is where the images are uploaded and every stage runs: the
    card unless the caller asks for another."""

    def __init__(self, num_features: int | None = None, num_levels: int | None = None,
                 scale_factor: float | None = None, fast_threshold: float | None = None,
                 cell: int = 16, per_cell: int = 6, *,
                 device: torch.device | str = "cuda"):
        self.num_features = num_features or Parameters.kNumFeatures
        self.num_levels = num_levels or Parameters.kNumLevels
        self.scale_factor = scale_factor or Parameters.kScaleFactor
        self.fast_threshold = fast_threshold or Parameters.kFASTThreshold
        self.cell = cell
        self.per_cell = per_cell
        self.device = torch.device(device)
        self.scale_factors = np.array(
            [self.scale_factor ** l for l in range(self.num_levels)], np.float32)
        self.sigma2 = level_sigma2(self.num_levels, self.scale_factor)
        self.inv_sigma2 = 1.0 / self.sigma2

    def _upload(self, *imgs) -> torch.Tensor:
        arr = np.stack([np.asarray(i) for i in imgs])
        return torch.as_tensor(arr).to(self.device).to(torch.float32)

    def _extract(self, imgs: torch.Tensor) -> FeatureData:
        return extract_batch(imgs, self.num_features, self.num_levels, self.scale_factor,
                             float(self.fast_threshold), self.cell, self.per_cell)

    def __call__(self, img) -> FeatureData:
        """(H, W) grey image -> FeatureData on ``device``."""
        f = self._extract(self._upload(img))
        return FeatureData(*[t[0] for t in f])

    def extract_stereo(self, img_l, img_r, bf: float, max_disp: float,
                       max_distance: float, row_tol: float):
        """Left + right extraction as one batch, then the row stereo match.
        Returns (left FeatureData, ur (N,), depth (N,)), all on ``device``."""
        f = self._extract(self._upload(img_l, img_r))
        fl = FeatureData(*[t[0] for t in f])
        fr = FeatureData(*[t[1] for t in f])
        ur, depth = stereo_match(fl, fr, bf, max_disp, max_distance, row_tol)
        return fl, ur, depth
