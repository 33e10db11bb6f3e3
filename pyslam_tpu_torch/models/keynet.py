"""Key.Net keypoint detector, handcrafted and learned filters (port of
``pyslam_tpu/models/keynet.py``).

A handcrafted block of 10 maps from Sobel derivatives (dx, dy, dx^2,
dy^2, dx*dy, dxy, dxy^2, dxx*dyy, dxx, dyy; kornia's order), a learned
block of 3 x [conv3x3 8 channels without bias, batch norm, ReLU] shared
over a 3-level pyramid (factor 1.2; the levels and the upsampling back to
full resolution through the JAX package's antialiased bilinear resize),
the 24 maps concatenated and a 1x1 convolution to the score map, then
ReLU.  ``KeyNetExtractor`` pairs it with a patch descriptor (HardNet by
default) over unoriented 31-px patches, the KEYNET and KEYNETAFFNETHARDNET
presets (AffNet's shape adaptation approximated by the patches, as in the
JAX package).  The modules carry the JAX package's names
(``learnable.conv{i}``, ``learnable.bn{i}``, ``last_conv``);
``torch_convert.keynet_from_torch`` maps an official checkpoint by order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import feature_data, resize_hw, single_level
from pyslam_tpu_torch.models.patch_descriptors import PatchDescriptorExtractor
from pyslam_tpu_torch.models.resnet import BN
from pyslam_tpu_torch.ops import image as image_ops
from pyslam_tpu_torch.ops import nms as nms_ops

_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0


def _conv2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x[None, None], k[None, None], padding=1)[0, 0]


def handcrafted_block(x: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (10, H, W) Sobel-derivative combinations."""
    kx = torch.from_numpy(_SOBEL_X).to(x.device)
    ky = kx.T.contiguous()
    dx, dy = _conv2(x, kx), _conv2(x, ky)
    dxx, dxy, dyy = _conv2(dx, kx), _conv2(dx, ky), _conv2(dy, ky)
    return torch.stack([dx, dy, dx * dx, dy * dy, dx * dy, dxy, dxy * dxy, dxx * dyy,
                        dxx, dyy])


class KeyNetLearnable(nn.Module):
    def __init__(self, filters: int = 8, blocks: int = 3):
        super().__init__()
        self.blocks = blocks
        cin = 10
        for i in range(blocks):
            self.add_module(f"conv{i}", nn.Conv2d(cin, filters, 3, padding=1, bias=False))
            self.add_module(f"bn{i}", BN(filters))
            cin = filters

    def forward(self, feats):                       # (10, H, W)
        x = feats[None]
        for i in range(self.blocks):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x[0]


class KeyNet(nn.Module):
    def __init__(self, levels: int = 3, scale: float = 1.2, filters: int = 8):
        super().__init__()
        self.levels, self.scale, self.filters = levels, scale, filters
        self.learnable = KeyNetLearnable(filters)
        self.last_conv = nn.Conv2d(levels * filters, 1, 1)

    def forward(self, img):                          # (H, W) in [0, 1]
        h, w = img.shape
        maps, cur = [], img
        for lv in range(self.levels):
            f = self.learnable(handcrafted_block(cur))
            maps.append(resize_hw(f, (h, w)) if lv > 0 else f)
            nh = max(int(round(h / (self.scale ** (lv + 1)))), 8)
            nw = max(int(round(w / (self.scale ** (lv + 1)))), 8)
            cur = resize_hw(img, (nh, nw))
        return F.relu(self.last_conv(torch.cat(maps)[None])[0, 0])


class KeyNetExtractor:
    """Key.Net keypoints + patch descriptors (``descriptor``: HARDNET,
    SOSNET, L2NET or TFEAT) -> FeatureData on ``device`` (``num_features``
    slots, size 31, unoriented, 128-d, L2).

    ``checkpoint``: an official Key.Net ``.pth``; without one seeded
    random weights (``trained = False``), the descriptor's too."""

    def __init__(self, num_features: int = 2000, checkpoint: str | None = None,
                 descriptor: str = "HARDNET", nms_cell: int = 8, *,
                 device: torch.device | str = "cuda"):
        single_level(self, num_features, device)
        self.nms_cell = nms_cell
        self.net = KeyNet()
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()
        self.descriptor = PatchDescriptorExtractor(descriptor, device=self.device)

    def load_checkpoint(self, path: str):
        from pyslam_tpu_torch.models import torch_convert

        self.net.load_state_dict(
            torch_convert.keynet_from_torch(torch_convert.load_torch_file(path)))
        self.trained = True

    def maps(self, img: torch.Tensor) -> dict[str, torch.Tensor]:
        """(H, W) float32 image on the device -> the score map (H, W)."""
        if float(img.max()) > 2.0:
            img = img / torch.tensor(255.0, device=img.device)   # a true division
        with torch.no_grad():
            return {"score": self.net(img)}

    def extract(self, img: torch.Tensor):
        n = self.num_features
        xy, resp, valid = nms_ops.grid_topk_keypoints(self.maps(img)["score"][None],
                                                      cell=self.nms_cell, per_cell=4, max_out=n)
        xy, resp, valid = xy[0], resp[0], valid[0]
        sizes = torch.full((n,), 31.0, dtype=torch.float32, device=img.device)
        angles = torch.full((n,), -1.0, dtype=torch.float32, device=img.device)
        desc = self.descriptor.compute(img, xy, sizes, angles)
        return feature_data(xy, resp, valid, desc, size=sizes, angle=angles)

    def __call__(self, img):
        return self.extract(image_ops.gray_image(img, self.device))
