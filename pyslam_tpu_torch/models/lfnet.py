"""LF-Net joint detector / descriptor (port of
``pyslam_tpu/models/lfnet.py``).

A residual tower of 5x5 convolutions over the image; score maps from the
tower's output resized over 5 scales in [1/1.6, 1.6] (a shared 1x1 conv,
each map resized back; the JAX package's antialiased bilinear resize),
softmaxed over the scale axis into a scale-space score and a per-pixel
scale; an orientation head (cos, sin).  Grid top-k keypoints, 32x32
patches at the predicted scale and orientation, and a descriptor tower of
3 stride-2 convolutions ("SAME", padded (0, 1)) and a dense layer to 256,
L2-normalised.  The modules carry the JAX package's names; its checkpoint
pair ``{checkpoint}.det.npz`` / ``.desc.npz`` is read by path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import conv_same, feature_data, resize_hw, single_level
from pyslam_tpu_torch.models.superpoint import _INV_255
from pyslam_tpu_torch.ops import image as image_ops
from pyslam_tpu_torch.ops import nms as nms_ops
from pyslam_tpu_torch.ops.patches import extract_oriented_patches

_RAD_TO_DEG = float(np.float32(180.0 / np.pi))   # jnp.degrees' float32 factor


@dataclass(frozen=True)
class LFNetConfig:
    base_ch: int = 16
    blocks: int = 3
    num_scales: int = 5
    scale_log_range: float = float(np.log(1.6))   # scales in [1/1.6, 1.6]
    desc_dim: int = 256


class LFNetDetector(nn.Module):
    def __init__(self, cfg: LFNetConfig):
        super().__init__()
        self.cfg = c = cfg
        self.stem = nn.Conv2d(1, c.base_ch, 5, padding=2)
        for i in range(c.blocks):
            self.add_module(f"res{i}a", nn.Conv2d(c.base_ch, c.base_ch, 5, padding=2))
            self.add_module(f"res{i}b", nn.Conv2d(c.base_ch, c.base_ch, 5, padding=2))
        self.score = nn.Conv2d(c.base_ch, 1, 1)
        self.ori = nn.Conv2d(c.base_ch, 2, 3, padding=1)
        self.logs = np.linspace(-c.scale_log_range, c.scale_log_range, c.num_scales)

    def forward(self, img):
        """(H, W) in [0, 1] -> score and scale maps (H, W) and the
        orientation head's (cos, sin) map (2, H, W)."""
        h, w = img.shape
        x = self.stem(img[None, None])
        for i in range(self.cfg.blocks):
            y = getattr(self, f"res{i}b")(F.relu(getattr(self, f"res{i}a")(x)))
            x = F.relu(x + y)
        maps = []
        for s in np.exp(self.logs):
            f = resize_hw(x, (max(int(h / s), 1), max(int(w / s), 1)))
            maps.append(resize_hw(self.score(f), (h, w))[0, 0])
        pyramid = torch.stack(maps)                          # (S, H, W)
        wts = torch.softmax(pyramid, dim=0)
        score = (wts * pyramid).sum(0)
        logs = torch.tensor(self.logs, dtype=torch.float32, device=img.device)
        scale = torch.exp((wts * logs[:, None, None]).sum(0))
        return score, scale, self.ori(x)[0]


class LFNetDescriptor(nn.Module):
    def __init__(self, cfg: LFNetConfig):
        super().__init__()
        cin = 1
        for i, ch in enumerate((64, 128, 256)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3, stride=2))
            cin = ch
        self.fc = nn.Linear(4 * 4 * 256, cfg.desc_dim)

    def forward(self, patches):                          # (N, 32, 32)
        x = patches[:, None]
        mu = x.mean((2, 3), keepdim=True)
        sd = torch.sqrt(((x - mu) ** 2).mean((2, 3), keepdim=True))
        x = (x - mu) / (sd + 1e-5)
        for i in range(3):
            x = F.relu(conv_same(getattr(self, f"conv{i}"), x))
        d = self.fc(x.permute(0, 2, 3, 1).flatten(1))    # the flax (h, w, c) order
        return d / torch.sqrt((d * d).sum(1, keepdim=True) + 1e-10)


class LFNetExtractor:
    """(H, W) image -> FeatureData on ``device``: ``num_features`` slots
    with the predicted size (16 px x scale) and orientation, 256-d unit
    descriptors (L2).  Without ``checkpoint`` seeded random weights
    (``trained = False``)."""

    def __init__(self, num_features: int = 1000, cfg: LFNetConfig | None = None,
                 checkpoint: str | None = None, nms_cell: int = 8, *,
                 device: torch.device | str = "cuda"):
        single_level(self, num_features, device)
        self.cfg = cfg or LFNetConfig()
        self.nms_cell = nms_cell
        self.det = LFNetDetector(self.cfg)
        self.desc = LFNetDescriptor(self.cfg)
        if checkpoint:
            for net, part in ((self.det, "det"), (self.desc, "desc")):
                net.load_state_dict(interop.same_names_state_dict(
                    interop.read_npz(f"{checkpoint}.{part}.npz")))
            self.trained = True
        else:
            interop.seeded_init_(self.det, 0)
            interop.seeded_init_(self.desc, 1)
        self.det.to(self.device).eval()
        self.desc.to(self.device).eval()

    def maps(self, img: torch.Tensor) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            score, scale, ori = self.det(img * _INV_255)
        return {"score": score, "scale": scale, "ori": ori}

    def extract(self, img: torch.Tensor):
        m = self.maps(img)
        xy, resp, valid = nms_ops.grid_topk_keypoints(m["score"][None], cell=self.nms_cell,
                                                      per_cell=4, max_out=self.num_features)
        xy, resp, valid = xy[0], resp[0], valid[0]
        xi = torch.clamp(xy[:, 0].to(torch.int64), 0, img.shape[1] - 1)
        yi = torch.clamp(xy[:, 1].to(torch.int64), 0, img.shape[0] - 1)
        sizes = 16.0 * m["scale"][yi, xi]
        ori = m["ori"][:, yi, xi]
        angles = torch.remainder(torch.atan2(ori[1], ori[0]) * _RAD_TO_DEG, 360.0)
        patches = extract_oriented_patches(img * _INV_255, xy, sizes, angles, patch_size=32,
                                           mag_factor=2.0)
        with torch.no_grad():
            d = self.desc(patches)
        return feature_data(xy, resp, valid, d, size=sizes, angle=angles)

    def __call__(self, img):
        return self.extract(image_ops.gray_image(img, self.device))
