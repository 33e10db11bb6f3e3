"""DISK detector / descriptor, the thin U-Net (port of
``pyslam_tpu/models/disk.py``).

Down channels (16, 32, 64, 64, 64), up channels (64, 64, 129); each block
one 5x5 convolution with bias, then PReLU and an instance norm (biased
variance, eps 1e-5 inside the root), except the last up block.  2x2 average
pooling down; up, a nearest resize to the skip's size (the source indices
``floor((i + 0.5) * in / out)`` of ``jax.image.resize``) and the skip
concatenated after.  As in the JAX package the up path ends at the second
level, so the heatmap, the descriptors and the keypoints are at half the
cropped image's resolution.  The modules carry the JAX package's names
(``down{i}.conv``, ``down{i}.prelu``, ``up{i}``); an official checkpoint
maps by registration order (``torch_convert.disk_from_torch``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import feature_data, l2_normalize, rgb_image, single_level
from pyslam_tpu_torch.models.superpoint import _INV_255
from pyslam_tpu_torch.ops import nms as nms_ops

DOWN = (16, 32, 64, 64, 64)
UP = (64, 64, 129)   # descriptors 128 + heatmap 1


def _instance_norm_hw(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean((2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean((2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, gate: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 5, padding=2)
        self.prelu = nn.Parameter(torch.full((cout,), 0.25)) if gate else None

    def forward(self, x):
        x = self.conv(x)
        if self.prelu is not None:
            x = _instance_norm_hw(torch.where(x >= 0, x, self.prelu.view(1, -1, 1, 1) * x))
        return x


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    src = np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                   * np.float32(n_in) / np.float32(n_out))
    return torch.from_numpy(src.astype(np.int64)).to(device)


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest resize of (B, C, H, W) to ``hw`` with the reference's
    source indices."""
    h, w = x.shape[-2:]
    if h != hw[0]:
        x = x.index_select(2, _nearest_index(h, hw[0], x.device))
    if w != hw[1]:
        x = x.index_select(3, _nearest_index(w, hw[1], x.device))
    return x


class DiskUNet(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for i, ch in enumerate(DOWN):
            self.add_module(f"down{i}", _ConvBlock(cin, ch))
            cin = ch
        for i, ch in enumerate(UP):
            self.add_module(f"up{i}", _ConvBlock(cin + DOWN[-2 - i], ch,
                                                 gate=i < len(UP) - 1))
            cin = ch

    def forward(self, x):
        """(B, 3, H, W), H and W multiples of 16 -> descriptors (B, 128,
        H/2, W/2) and heatmap (B, H/2, W/2)."""
        skips = []
        for i in range(len(DOWN)):
            if i > 0:
                x = F.avg_pool2d(x, 2)
            x = getattr(self, f"down{i}")(x)
            skips.append(x)
        for i in range(len(UP)):
            skip = skips[len(DOWN) - 2 - i]
            x = resize_nearest(x, skip.shape[-2:])
            x = getattr(self, f"up{i}")(torch.cat([x, skip], 1))
        return x[:, :128], x[:, 128]


class DiskExtractor:
    """(H, W) grey or (H, W, 3) image -> FeatureData on ``device``
    (``num_features`` slots, size 8, 128-d unit descriptors, L2).

    ``checkpoint``: an official ``.pth`` (``extractor`` entry or a bare
    state dict); without one seeded random weights (``trained = False``)."""

    def __init__(self, num_features: int = 2000, checkpoint: str | None = None,
                 nms_cell: int = 8, *, device: torch.device | str = "cuda"):
        single_level(self, num_features, device)
        self.nms_cell = nms_cell
        self.net = DiskUNet()
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        from pyslam_tpu_torch.models import torch_convert

        self.net.load_state_dict(
            torch_convert.disk_from_torch(torch_convert.load_torch_file(path, "extractor")))
        self.trained = True

    def maps(self, img: torch.Tensor) -> dict[str, torch.Tensor]:
        """(H, W, 3) float32 image on the device -> descriptor map (128,
        h, w) and heatmap (h, w) of the crop to multiples of 16."""
        h, w = img.shape[:2]
        x = img[: h // 16 * 16, : w // 16 * 16].permute(2, 0, 1)[None] * _INV_255
        with torch.no_grad():
            desc, heat = self.net(x)
        return {"desc": desc[0], "heat": heat[0]}

    def extract(self, img: torch.Tensor):
        m = self.maps(img)
        desc, heat = m["desc"], m["heat"]
        xy, resp, valid = nms_ops.grid_topk_keypoints(heat[None], cell=self.nms_cell,
                                                      per_cell=4, max_out=self.num_features)
        xy, resp, valid = xy[0], resp[0], valid[0]
        # the reference clamps to the crop; the gather then to the map
        h, w = img.shape[0] // 16 * 16, img.shape[1] // 16 * 16
        xi = torch.clamp(xy[:, 0].to(torch.int64), 0, min(w, desc.shape[2]) - 1)
        yi = torch.clamp(xy[:, 1].to(torch.int64), 0, min(h, desc.shape[1]) - 1)
        return feature_data(xy, resp, valid, l2_normalize(desc[:, yi, xi].T, 1))

    def __call__(self, img):
        return self.extract(rgb_image(img, self.device))
