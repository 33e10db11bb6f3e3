"""DELF attention-based local features (port of
``pyslam_tpu/models/delf.py``).

A small ResNet-style trunk at stride 16 (a 7x7 stride-4 stem, two stages
of a stride-2 conv and a residual pair; batch norm with running
statistics, flax "SAME" padding), an attention head (1x1 conv 64, ReLU,
1x1 conv 1, softplus) scoring every location, and a learned linear
projection to 40 dimensions (DELF's PCA), L2-normalised.  Two pyramid
levels (1 and 0.7071, each cropped to a multiple of 16 by the JAX
package's antialiased resize); the candidates of both share one top-k
(ties to the lower index, as ``jax.lax.top_k``) and sit at their
receptive fields' centres.  DELF is also what the HDC_DELF loop detector
reuses.  The modules carry the JAX package's names; its checkpoint pair
``{checkpoint}.trunk.npz`` / ``.head.npz`` is read by path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import (
    conv_same,
    feature_data,
    l2_normalize,
    resize_hw,
    single_level,
)
from pyslam_tpu_torch.models.resnet import BN
from pyslam_tpu_torch.models.superpoint import _INV_255
from pyslam_tpu_torch.ops import image as image_ops
from pyslam_tpu_torch.ops.nms import _topk_stable

STRIDE = 16.0


@dataclass(frozen=True)
class DELFConfig:
    trunk_ch: tuple = (32, 64, 128)    # 3 stages, stride 4 x 2 x 2 = 16
    attn_ch: int = 64
    desc_dim: int = 40                 # DELF's PCA output dimensionality
    levels: tuple = (1.0, 0.7071)      # image pyramid scales


class DELFTrunk(nn.Module):
    def __init__(self, cfg: DELFConfig):
        super().__init__()
        c0 = cfg.trunk_ch[0]
        self.stem = nn.Conv2d(1, c0, 7, stride=4, bias=False)
        self.stem_bn = BN(c0)
        cin = c0
        self.stages = len(cfg.trunk_ch) - 1
        for i, ch in enumerate(cfg.trunk_ch[1:]):
            self.add_module(f"down{i}", nn.Conv2d(cin, ch, 3, stride=2, bias=False))
            self.add_module(f"down{i}_bn", BN(ch))
            for part in "ab":
                self.add_module(f"res{i}{part}", nn.Conv2d(ch, ch, 3, padding=1, bias=False))
                self.add_module(f"res{i}{part}_bn", BN(ch))
            cin = ch

    def forward(self, img):                      # (H, W) in [0, 1] -> (C, H/16, W/16)
        x = F.relu(self.stem_bn(conv_same(self.stem, img[None, None])))
        for i in range(self.stages):
            x = F.relu(getattr(self, f"down{i}_bn")(conv_same(getattr(self, f"down{i}"), x)))
            y = F.relu(getattr(self, f"res{i}a_bn")(getattr(self, f"res{i}a")(x)))
            x = F.relu(x + getattr(self, f"res{i}b_bn")(getattr(self, f"res{i}b")(y)))
        return x[0]


class DELFHead(nn.Module):
    """Attention scores and projected descriptors."""

    def __init__(self, cfg: DELFConfig):
        super().__init__()
        c = cfg.trunk_ch[-1]
        self.attn1 = nn.Conv2d(c, cfg.attn_ch, 1)
        self.attn2 = nn.Conv2d(cfg.attn_ch, 1, 1)
        self.pca = nn.Linear(c, cfg.desc_dim)

    def forward(self, feat):                     # (C, h, w)
        a = self.attn2(F.relu(self.attn1(feat[None])))
        attn = F.softplus(a[0, 0])
        d = self.pca(feat.permute(1, 2, 0))
        return attn, l2_normalize(d)


class DELFExtractor:
    """(H, W) image -> FeatureData on ``device``: ``num_features`` slots of
    the top attention locations over both levels, size 16 / level scale,
    40-d unit descriptors (L2).  Without ``checkpoint`` seeded random
    weights (``trained = False``)."""

    def __init__(self, num_features: int = 1000, cfg: DELFConfig | None = None,
                 checkpoint: str | None = None, *, device: torch.device | str = "cuda"):
        single_level(self, num_features, device)
        self.cfg = cfg or DELFConfig()
        self.trunk = DELFTrunk(self.cfg)
        self.head = DELFHead(self.cfg)
        if checkpoint:
            for net, part in ((self.trunk, "trunk"), (self.head, "head")):
                net.load_state_dict(interop.same_names_state_dict(
                    interop.read_npz(f"{checkpoint}.{part}.npz")))
            self.trained = True
        else:
            interop.seeded_init_(self.trunk, 0)
            interop.seeded_init_(self.head, 1)
        self.trunk.to(self.device).eval()
        self.head.to(self.device).eval()

    def maps(self, img: torch.Tensor) -> dict[str, torch.Tensor]:
        """(H, W) float32 image on the device -> each level's attention
        (h, w) and descriptor (h, w, 40) maps."""
        h, w = img.shape
        out = {}
        with torch.no_grad():
            for lv, s in enumerate(self.cfg.levels):
                hw = (max(int(h * s) // 16 * 16, 32), max(int(w * s) // 16 * 16, 32))
                attn, desc = self.head(self.trunk(resize_hw(img, hw) * _INV_255))
                out[f"attn{lv}"], out[f"desc{lv}"] = attn, desc
        return out

    def extract(self, img: torch.Tensor):
        m = self.maps(img)
        dev, n = img.device, self.num_features
        scores, xys, descs, sizes = [], [], [], []
        for lv, s in enumerate(self.cfg.levels):
            attn, desc = m[f"attn{lv}"], m[f"desc{lv}"]
            h, w = attn.shape
            ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                    indexing="ij")
            inv_s = float(np.float32(1.0) / np.float32(s))   # XLA's reciprocal of s
            px = (xs.reshape(-1) + 0.5) * STRIDE * inv_s
            py = (ys.reshape(-1) + 0.5) * STRIDE * inv_s
            scores.append(attn.reshape(-1))
            xys.append(torch.stack([px, py], 1))
            descs.append(desc.reshape(-1, desc.shape[-1]))
            sizes.append(torch.full((h * w,), STRIDE / s, dtype=torch.float32, device=dev))
        scores = torch.cat(scores)
        k = min(n, scores.shape[0])
        v, idx = _topk_stable(scores, k)
        pad = n - k

        def padded(x):
            return F.pad(x, (0, 0, 0, pad) if x.dim() == 2 else (0, pad))

        valid = padded(torch.ones(k, dtype=torch.bool, device=dev))
        return feature_data(padded(torch.cat(xys)[idx]), padded(v), valid,
                            padded(torch.cat(descs)[idx]), size=padded(torch.cat(sizes)[idx]))

    def __call__(self, img):
        return self.extract(image_ops.gray_image(img, self.device))
