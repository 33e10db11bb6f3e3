"""XFeat detector / descriptor (port of ``pyslam_tpu/models/xfeat.py``).

The public XFeat network with the public XFeatModel's module names
(``block1..block5``, ``skip1``, ``block_fusion``, ``heatmap_head``,
``keypoint_head``; a ``BasicLayer`` is ``layer.0`` conv without bias,
``layer.1`` batch norm without affine, ReLU), so the official checkpoint
loads after ``torch_convert.xfeat_from_torch`` drops its ``fine_matcher``.
Instance-normalised input, five encoder blocks with an average-pool skip,
fusion at 1/8 resolution (bilinear upsampling as ``jax.image.resize``), a
64-d descriptor map, a reliability heatmap and 65-way keypoint logits over
the 8x8 blocks of the raw image.

``XFeatExtractor`` decodes as the JAX package: crop to multiples of 32,
scale by 1/255, cell softmax without the dustbin scattered back to pixels,
grid top-k (cell 8, 2 a cell), responses weighted by the bilinear
reliability at keypoint / 8, descriptors bilinear from the 1/8 map and
L2-normalised.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import (
    BatchNormRS,
    feature_data,
    l2_normalize,
    resize_hw,
    single_level,
)
from pyslam_tpu_torch.models.superpoint import _INV_255
from pyslam_tpu_torch.ops import image as image_ops
from pyslam_tpu_torch.ops import nms as nms_ops


class BasicLayer(nn.Module):
    """Conv (no bias) + BatchNorm (running statistics, no affine) + ReLU;
    symmetric padding, as torch pads (the JAX package pads explicitly)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.layer = nn.Sequential(
            nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False),
            BatchNormRS(cout), nn.ReLU())

    def forward(self, x):
        return self.layer(x)


def _unfold2d(x: torch.Tensor, ws: int = 8) -> torch.Tensor:
    """(B, 1, H, W) -> (B, ws*ws, H/ws, W/ws): a block's pixels row by row
    as channels."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // ws, ws, w // ws, ws)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, c * ws * ws, h // ws, w // ws)


class XFeatNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.skip1 = nn.Sequential(nn.AvgPool2d(4, stride=4), nn.Conv2d(1, 24, 1))
        self.block1 = nn.Sequential(BasicLayer(1, 4), BasicLayer(4, 8, stride=2),
                                    BasicLayer(8, 8), BasicLayer(8, 24, stride=2))
        self.block2 = nn.Sequential(BasicLayer(24, 24), BasicLayer(24, 24))
        self.block3 = nn.Sequential(BasicLayer(24, 64, stride=2), BasicLayer(64, 64),
                                    BasicLayer(64, 64, 1, padding=0))
        self.block4 = nn.Sequential(BasicLayer(64, 64, stride=2), BasicLayer(64, 64),
                                    BasicLayer(64, 64))
        self.block5 = nn.Sequential(BasicLayer(64, 128, stride=2), BasicLayer(128, 128),
                                    BasicLayer(128, 128), BasicLayer(128, 64, 1, padding=0))
        self.block_fusion = nn.Sequential(BasicLayer(64, 64), BasicLayer(64, 64),
                                          nn.Conv2d(64, 64, 1))
        self.heatmap_head = nn.Sequential(BasicLayer(64, 64, 1, padding=0),
                                          BasicLayer(64, 64, 1, padding=0),
                                          nn.Conv2d(64, 1, 1), nn.Sigmoid())
        self.keypoint_head = nn.Sequential(BasicLayer(64, 64, 1, padding=0),
                                           BasicLayer(64, 64, 1, padding=0),
                                           BasicLayer(64, 64, 1, padding=0),
                                           nn.Conv2d(64, 65, 1))

    def forward(self, x):
        """(B, 1, H, W), H and W multiples of 32 -> descriptor features
        (B, 64, H/8, W/8), keypoint logits (B, 65, H/8, W/8) and the
        reliability heatmap (B, 1, H/8, W/8)."""
        mu = x.mean((2, 3), keepdim=True)
        var = ((x - mu) ** 2).mean((2, 3), keepdim=True)
        xn = (x - mu) / torch.sqrt(var + 1e-5)
        x1 = self.block1(xn)
        x2 = self.block2(x1 + self.skip1(xn))
        x3 = self.block3(x2)
        x4 = self.block4(x3)
        x5 = self.block5(x4)
        hw = x3.shape[-2:]
        feats = self.block_fusion(x3 + resize_hw(x4, hw) + resize_hw(x5, hw))
        heat = self.heatmap_head(feats)
        klogits = self.keypoint_head(_unfold2d(xn, 8))
        return feats, klogits, heat


def kpts_heatmap(klogits: torch.Tensor) -> torch.Tensor:
    """(65, H8, W8) logits -> (8*H8, 8*W8) keypoint probability: the
    dustbin dropped, the reference's (H8, W8, 8, 8) -> (H8, 8, W8, 8)."""
    scores = torch.softmax(klogits, dim=0)[:64]
    _, h8, w8 = scores.shape
    return (scores.permute(1, 2, 0).reshape(h8, w8, 8, 8).permute(0, 2, 1, 3)
            .reshape(h8 * 8, w8 * 8))


class XFeatExtractor:
    """(H, W) grey image -> FeatureData on ``device``: ``num_features``
    slots, level 0, size 8, angle 0, 64-d unit descriptors (L2).

    ``checkpoint``: the public ``xfeat.pt`` or a JAX-package ``.npz``;
    without one seeded random weights (``trained = False``)."""

    def __init__(self, num_features: int = 2000, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        single_level(self, num_features, device)
        self.net = XFeatNet()
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        if str(path).endswith((".pth", ".pt")):
            from pyslam_tpu_torch.models import torch_convert

            state = torch_convert.xfeat_from_torch(torch_convert.load_torch_file(path))
        else:
            state = interop.xfeat_state_dict(interop.read_npz(path))
        self.net.load_state_dict(state)
        self.trained = True

    def maps(self, img: torch.Tensor) -> dict[str, torch.Tensor]:
        """(H, W) float32 image on the device -> the network's maps for
        the crop to multiples of 32."""
        h, w = img.shape
        x = img[None, None, : h // 32 * 32, : w // 32 * 32] * _INV_255
        with torch.no_grad():
            feats, klogits, heat = self.net(x)
        return {"feats": feats[0], "klogits": klogits[0], "heat": heat[0, 0]}

    def extract(self, img: torch.Tensor):
        m = self.maps(img)
        rel, dmap = m["heat"], m["feats"]
        xy, resp, valid = nms_ops.grid_topk_keypoints(kpts_heatmap(m["klogits"])[None], cell=8,
                                                      per_cell=2, max_out=self.num_features)
        xy, resp, valid = xy[0], resp[0], valid[0]
        # score = keypoint probability * bilinear reliability at kp / 8
        h8, w8 = rel.shape
        gx = torch.clamp(xy[:, 0] / 8.0, 0.0, float(np.float32(w8 - 1.001)))
        gy = torch.clamp(xy[:, 1] / 8.0, 0.0, float(np.float32(h8 - 1.001)))
        x0, y0 = gx.to(torch.int64), gy.to(torch.int64)
        fx, fy = gx - x0, gy - y0
        r = (rel[y0, x0] * (1 - fx) * (1 - fy) + rel[y0, x0 + 1] * fx * (1 - fy)
             + rel[y0 + 1, x0] * (1 - fx) * fy + rel[y0 + 1, x0 + 1] * fx * fy)
        d = (dmap[:, y0, x0] * ((1 - fx) * (1 - fy)) + dmap[:, y0, x0 + 1] * (fx * (1 - fy))
             + dmap[:, y0 + 1, x0] * ((1 - fx) * fy) + dmap[:, y0 + 1, x0 + 1] * (fx * fy))
        return feature_data(xy, resp * r, valid, l2_normalize(d.T, 1))

    def __call__(self, img):
        """(H, W) grey (or (H, W, 3)) image -> FeatureData on ``device``."""
        return self.extract(image_ops.gray_image(img, self.device))
