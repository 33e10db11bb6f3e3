"""Semantic TSDF volume: per-voxel class fusion on the voxel-hash table
(port of ``pyslam_tpu/dense/semantic_volume.py``).

``class_scores`` (capacity, C) lives on the volume's device beside the
table.  ``integrate_semantic`` fuses a depth image as ``integrate`` does
(``depth_to_voxel_updates``, ``voxel_hash.insert_and_accumulate``), looks
the updates' voxels up, and scatters each valid update's class evidence
into its slot: COUNTING adds the one-hot label times the update's weight,
BAYESIAN (with per-pixel probabilities) the log-probabilities.  The
scatter is one ``index_add_`` into a buffer with one row more than the
table, where the dropped updates (no slot, invalid, a label out of range)
land and are cut off: the reference's ``.at[slot].add(mode="drop")``.  On
the card the additions into a slot come in atomic order, so the scores
match the CPU's to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import enum

import numpy as np
import torch
import torch.nn.functional as F

from pyslam_tpu_torch.dense.tsdf import TSDFVolume, depth_to_voxel_updates
from pyslam_tpu_torch.ops import voxel_hash
from pyslam_tpu_torch.utils.device import as_device_tensor


class SemanticFusionMethod(enum.Enum):
    COUNTING = "counting"
    BAYESIAN = "bayesian"
    AVERAGING = "averaging"


class SemanticTSDFVolume(TSDFVolume):
    def __init__(self, num_classes: int = 21,
                 fusion: SemanticFusionMethod = SemanticFusionMethod.COUNTING, **kw):
        super().__init__(**kw)
        self.num_classes = num_classes
        self.fusion = fusion
        self.class_scores = self._zero_scores()

    def _zero_scores(self) -> torch.Tensor:
        return torch.zeros((self.capacity, self.num_classes), dtype=torch.float32,
                           device=self.device)

    def reset(self):
        super().reset()
        self.class_scores = self._zero_scores()

    def integrate_semantic(self, depth, intensity, labels, Twc, K, label_probs=None):
        """Fuse a depth image with its per-pixel class ``labels`` (H, W)
        int, and for BAYESIAN fusion its (H, W, C) probabilities."""
        if self.stride is None:
            fx = float(np.asarray(K)[0, 0])
            self.stride = int(np.clip(self.voxel_size * fx / max(self.depth_trunc, 1e-6), 1, 4))
        dev = self.device
        depth = as_device_tensor(depth, dev)
        coords, sdf, w, col, valid = depth_to_voxel_updates(
            depth, as_device_tensor(intensity, dev), as_device_tensor(Twc, dev),
            as_device_tensor(K, dev), self.voxel_size, self.sdf_trunc, self.depth_trunc,
            self.stride, self.band_steps)
        self.table = voxel_hash.insert_and_accumulate(self.table, coords, sdf, w, col, valid)
        # the updates' pixels: the strided grid, each pixel's band of
        # 2 * band_steps + 1 samples in a row
        H, W = depth.shape
        gy, gx = torch.meshgrid(torch.arange(0, H, self.stride, device=dev),
                                torch.arange(0, W, self.stride, device=dev), indexing="ij")
        gy, gx = gy.reshape(-1), gx.reshape(-1)
        band = 2 * self.band_steps + 1
        upd_lab = as_device_tensor(labels, dev).to(torch.int64)[gy, gx].repeat_interleave(band)
        slots = voxel_hash.lookup(self.table, coords)
        C = self.capacity
        ok = (slots >= 0) & valid & (upd_lab >= 0) & (upd_lab < self.num_classes)
        idx = torch.where(ok, slots, torch.full_like(slots, C))
        if label_probs is not None and self.fusion == SemanticFusionMethod.BAYESIAN:
            probs = as_device_tensor(label_probs, dev).to(torch.float32)[gy, gx]
            upd = torch.log(torch.clamp(probs.repeat_interleave(band, 0), 1e-6, 1.0))
        else:
            upd = F.one_hot(torch.clamp(upd_lab, 0, self.num_classes - 1),
                            self.num_classes).to(torch.float32) * w[:, None]
        acc = torch.cat([self.class_scores, self.class_scores.new_zeros(1, self.num_classes)])
        acc.index_add_(0, idx, upd)
        self.class_scores = acc[:C]

    def extract_semantic_point_cloud(self, tsdf_band: float = 0.5, min_weight: float = 1.0):
        """Voxel centres near the zero crossing -> (points (N, 3), labels)."""
        tsdf = self._np("tsdf")
        sel = self._np("occupied") & (np.abs(tsdf) < tsdf_band) & (self._np("weight") >= min_weight)
        pts = (self._np("keys")[sel].astype(np.float64) + 0.5) * self.voxel_size
        labels = torch.argmax(self.class_scores, 1).cpu().numpy()[sel]
        return pts, labels
