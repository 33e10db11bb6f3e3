"""SuperPoint detector / descriptor (port of
``pyslam_tpu/models/superpoint.py``).

The public SuperPoint design: a VGG-style shared encoder (64, 64, 128,
128 channels, three 2x2 pools), an 8x8-cell detection head with a
dustbin (65 channels) and a 256-d descriptor head.  The module keeps
MagicLeap's names (``conv1a..convDb``), so the official
``superpoint_v1.pth`` loads as it is.  ``SuperPointExtractor`` decodes in
one device pass: crop to multiples of 8, scale by 1/255, cell softmax
without the dustbin, unfold to full resolution, confidence threshold, grid
top-k (cell 16, 6 a cell), nearest-cell descriptors, L2 normalisation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.features.orb2 import FeatureData
from pyslam_tpu_torch.ops import image as image_ops
from pyslam_tpu_torch.ops import nms as nms_ops

_INV_255 = float(np.float32(1.0 / 255.0))   # XLA's reciprocal of a constant divisor


class SuperPointNet(nn.Module):
    def __init__(self, det_channels: int = 65, desc_dim: int = 256):
        super().__init__()
        c = (1, 64, 64, 128, 128)
        for i, blk in enumerate("1234"):
            self.add_module(f"conv{blk}a", nn.Conv2d(c[i], c[i + 1], 3, padding=1))
            self.add_module(f"conv{blk}b", nn.Conv2d(c[i + 1], c[i + 1], 3, padding=1))
        self.convPa = nn.Conv2d(128, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, det_channels, 1)
        self.convDa = nn.Conv2d(128, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, desc_dim, 1)

    def forward(self, x):
        """(B, 1, H, W) in [0, 1] -> detector logits (B, 65, H/8, W/8) and
        the dense descriptor map (B, 256, H/8, W/8), not normalised."""
        for i, blk in enumerate("1234"):
            x = F.relu(getattr(self, f"conv{blk}a")(x))
            x = F.relu(getattr(self, f"conv{blk}b")(x))
            if i < 3:
                x = F.max_pool2d(x, 2, stride=2)
        det = self.convPb(F.relu(self.convPa(x)))
        desc = self.convDb(F.relu(self.convDa(x)))
        return det, desc


class SuperPointExtractor:
    """(H, W) grey image -> FeatureData on ``device``: ``num_features``
    slots, level 0, size 8, angle 0, float32 unit descriptors (L2).

    ``checkpoint``: MagicLeap's ``.pth`` / ``.pt``, a JAX-package
    ``.npz``, or None for the bundled ``superpoint_tiny.npz``; random
    weights (``trained = False``) when there is none."""

    def __init__(self, num_features: int = 1000, checkpoint: str | None = None,
                 nms_cell: int = 16, conf_threshold: float = 0.015, *,
                 device: torch.device | str = "cuda"):
        self.num_features = num_features
        self.nms_cell = nms_cell
        self.conf_threshold = conf_threshold
        self.device = torch.device(device)
        self.net = SuperPointNet()
        self.trained = False
        if checkpoint is None:
            checkpoint = interop.bundled_checkpoint("superpoint_tiny")
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()
        self.scale_factors = np.array([1.0], np.float32)
        self.sigma2 = np.array([1.0], np.float32)
        self.inv_sigma2 = 1.0 / self.sigma2

    def load_checkpoint(self, path: str):
        """Load MagicLeap's torch checkpoint or a JAX-package ``.npz``."""
        if str(path).endswith((".pth", ".pt")):
            from pyslam_tpu_torch.models.torch_convert import load_torch_file

            state = load_torch_file(path)
        else:
            state = interop.superpoint_state_dict(interop.read_npz(path))
        self.net.load_state_dict(state)
        self.trained = True

    def maps(self, img: torch.Tensor):
        """(H, W) float32 image on the device -> the keypoint probability
        map (8*hc, 8*wc) (cell softmax without the dustbin, unfolded) and
        the dense descriptors (256, hc, wc)."""
        h, w = img.shape
        hc, wc = h // 8, w // 8
        with torch.no_grad():
            det, desc = self.net(img[None, None, : hc * 8, : wc * 8] * _INV_255)
        prob = torch.softmax(det[0], dim=0)[:64]                   # (64, hc, wc)
        # the reference's (hc, wc, 8, 8) -> (hc, 8, wc, 8) unfold
        prob = (prob.permute(1, 2, 0).reshape(hc, wc, 8, 8).permute(0, 2, 1, 3)
                .reshape(hc * 8, wc * 8))
        return prob, desc[0]

    def extract(self, img: torch.Tensor) -> FeatureData:
        n = self.num_features
        prob, desc = self.maps(img)
        hc, wc = desc.shape[1:]
        score = torch.where(prob > self.conf_threshold, prob, torch.zeros_like(prob))
        xy, resp, valid = nms_ops.grid_topk_keypoints(score[None], cell=self.nms_cell,
                                                      per_cell=6, max_out=n)
        xy, resp, valid = xy[0], resp[0], valid[0]
        # nearest-cell descriptors, L2-normalised
        cx = torch.clamp((xy[:, 0] / 8).to(torch.int64), 0, wc - 1)
        cy = torch.clamp((xy[:, 1] / 8).to(torch.int64), 0, hc - 1)
        d = desc[:, cy, cx].T
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-9)
        dev = img.device
        return FeatureData(
            xy=xy, level=torch.zeros(n, dtype=torch.int64, device=dev),
            angle=torch.zeros(n, dtype=torch.float32, device=dev),
            size=torch.full((n,), 8.0, dtype=torch.float32, device=dev),
            response=resp, desc=d.contiguous(), valid=valid)

    def __call__(self, img) -> FeatureData:
        """(H, W) grey (or (H, W, 3)) image -> FeatureData on ``device``."""
        return self.extract(image_ops.gray_image(img, self.device))
