"""DepthAnythingV2: a DINOv2 ViT and a DPT head (port of
``pyslam_tpu/models/depth_anything_v2.py``).

The encoder is a DINOv2 ViT-S/14: a class token, a learned position
embedding, ``ViTBlock`` blocks (pre-LayerNorm self-attention with a fused
qkv and LayerScale, then a pre-LayerNorm MLP with the exact-erf GELU and
LayerScale), its final LayerNorm applied to each of four taps.  The DPT
head projects each tap (1x1), resizes the pyramid (4x and 2x transposed
convolutions, identity, a stride-2 3x3 convolution), fuses it coarse to
fine with RefineNet blocks (``FusionBlock``: residual conv units, a
bilinear upsample, a 1x1 convolution) and regresses relative inverse depth.
MegaLoc's ViT (``models.megaloc``) is built from ``ViTBlock``.

Flax's ``ConvTranspose(transpose_kernel=True)`` with "VALID" padding and a
stride equal to its kernel is torch's ``ConvTranspose2d`` with no padding,
its kernel (kh, kw, out, in) the torch weight (in, out, kh, kw).  The
bilinear resizes are ``jax.image.resize``'s (``layers.resize_hw``),
LayerNorm flax's (eps 1e-6, fast variance).  The modules carry the JAX
package's names; ``torch_convert.depth_anything_v2_from_torch`` maps the
official checkpoint (``pretrained.*`` + ``depth_head.*``).  Without a
checkpoint the weights are seeded random ones (``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.dust3r import _attend, _heads_last
from pyslam_tpu_torch.models.layers import autotuned_convs, layer_norm, resize_hw


@dataclass
class DAv2Config:
    img_hw: tuple = (266, 350)          # multiples of patch (14)
    patch: int = 14
    dim: int = 384
    depth: int = 12
    heads: int = 6
    taps: tuple = (2, 5, 8, 11)         # intermediate layers feeding the DPT
    out_ch: tuple = (48, 96, 192, 384)  # per-tap projection channels (vits)
    features: int = 64                  # DPT fusion width


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.attn_proj = nn.Linear(dim, dim)
        self.ls1 = nn.Parameter(torch.ones(dim))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.ls2 = nn.Parameter(torch.ones(dim))

    def forward(self, x):                    # (..., N, D) tokens, cls first
        qkv = self.qkv(layer_norm(self.norm1, x)).unflatten(-1, (3, self.heads, -1))
        q, k, v = (qkv[..., i, :, :].transpose(-3, -2) for i in range(3))
        x = x + self.attn_proj(_heads_last(_attend(q, k, v))) * self.ls1
        y = self.fc2(F.gelu(self.fc1(layer_norm(self.norm2, x))))
        return x + y * self.ls2


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionBlock(nn.Module):
    """RefineNet fusion over (B, C, H, W); ``skip``: the block has the
    skip's residual unit ``rcu1`` (the coarsest block has none)."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.rcu1 = ResidualConvUnit(features)
        self.rcu2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        if out_hw is None:
            out_hw = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(resize_hw(x, tuple(out_hw)))


class DepthAnythingV2Net(nn.Module):
    def __init__(self, cfg: DAv2Config):
        super().__init__()
        self.cfg = c = cfg
        h8, w8 = c.img_hw[0] // c.patch, c.img_hw[1] // c.patch
        self.patch_embed = nn.Conv2d(3, c.dim, c.patch, stride=c.patch)
        self.cls_token = nn.Parameter(torch.zeros(1, c.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1 + h8 * w8, c.dim))
        self.encoder_norm = nn.LayerNorm(c.dim, eps=1e-6)
        for i in range(c.depth):
            self.add_module(f"block_{i}", ViTBlock(c.dim, c.heads))
        for j, oc in enumerate(c.out_ch):
            self.add_module(f"project_{j}", nn.Conv2d(c.dim, oc, 1))
            self.add_module(f"layer{j + 1}_rn", nn.Conv2d(oc, c.features, 3, padding=1,
                                                          bias=False))
        self.resize_0 = nn.ConvTranspose2d(c.out_ch[0], c.out_ch[0], 4, stride=4)
        self.resize_1 = nn.ConvTranspose2d(c.out_ch[1], c.out_ch[1], 2, stride=2)
        self.resize_3 = nn.Conv2d(c.out_ch[3], c.out_ch[3], 3, stride=2, padding=1)
        for r in range(1, 5):
            self.add_module(f"refine{r}", FusionBlock(c.features, skip=r < 4))
        self.output_conv1 = nn.Conv2d(c.features, c.features // 2, 3, padding=1)
        self.output_conv2a = nn.Conv2d(c.features // 2, 32, 3, padding=1)
        self.output_conv2b = nn.Conv2d(32, 1, 1)

    def encode(self, img):
        """(H, W, 3) -> the four normalised taps, each (P, D) without cls."""
        c = self.cfg
        tokens = self.patch_embed(img.permute(2, 0, 1)[None]).flatten(2)[0].T
        t = torch.cat([self.cls_token, tokens], 0) + self.pos_embed
        taps = []
        for i in range(c.depth):
            t = getattr(self, f"block_{i}")(t)
            if i in c.taps:
                taps.append(layer_norm(self.encoder_norm, t)[1:])
        return taps

    def forward(self, img):                  # (H, W, 3) ImageNet-normalised
        c = self.cfg
        h8, w8 = c.img_hw[0] // c.patch, c.img_hw[1] // c.patch
        taps = self.encode(img)
        with autotuned_convs():
            feats = []
            for j, tap in enumerate(taps):
                f = getattr(self, f"project_{j}")(tap.T.reshape(1, c.dim, h8, w8))
                if j in (0, 1, 3):
                    f = getattr(self, f"resize_{j}")(f)
                feats.append(getattr(self, f"layer{j + 1}_rn")(f))
            l1, l2, l3, l4 = feats
            p4 = self.refine4(l4, out_hw=l3.shape[-2:])
            p3 = self.refine3(p4, l3, out_hw=l2.shape[-2:])
            p2 = self.refine2(p3, l2, out_hw=l1.shape[-2:])
            p1 = self.refine1(p2, l1)
            y = resize_hw(self.output_conv1(p1), tuple(c.img_hw))
            y = self.output_conv2b(F.relu(self.output_conv2a(y)))
        return F.relu(y[0, 0])


_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
_IMAGENET_STD = np.array([0.229, 0.224, 0.225])


class DepthAnythingV2:
    """Image -> relative inverse depth on ``device`` at a fixed network
    size.  ``checkpoint``: an official ``.pth`` / ``.pt`` or the JAX
    package's ``.npz``; without one seeded random weights."""

    def __init__(self, cfg: DAv2Config | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or DAv2Config()
        self.device = torch.device(device)
        self.net = DepthAnythingV2Net(self.cfg)
        self.trained = False
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        if str(path).endswith((".pth", ".pt")):
            from pyslam_tpu_torch.models.torch_convert import depth_anything_v2_from_torch_file

            sd = depth_anything_v2_from_torch_file(path, self.cfg)
        else:
            sd = interop.depth_anything_v2_state_dict(interop.read_npz(path))
        self.net.load_state_dict(sd)
        self.trained = True

    def prepare(self, img) -> np.ndarray:
        """Host pre-processing: grey -> 3 channels, the network size by
        ``floor(i * H / h)`` sampling, /255, ImageNet normalisation."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        h, w = self.cfg.img_hw
        ys = np.clip((np.arange(h) * img.shape[0] / h).astype(int), 0, img.shape[0] - 1)
        xs = np.clip((np.arange(w) * img.shape[1] / w).astype(int), 0, img.shape[1] - 1)
        x = img[ys][:, xs] / 255.0
        return np.ascontiguousarray((x - _IMAGENET_MEAN) / _IMAGENET_STD, np.float32)

    def run(self, x: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return self.net(torch.from_numpy(x).to(self.device))

    def infer(self, img) -> np.ndarray:
        """(H, W[, 3]) [0, 255] -> relative depth at the input resolution
        (nearest)."""
        orig_hw = np.asarray(img).shape[:2]
        d = self.run(self.prepare(img)).cpu().numpy()
        h, w = self.cfg.img_hw
        ys = np.clip((np.arange(orig_hw[0]) * h / orig_hw[0]).astype(int), 0, h - 1)
        xs = np.clip((np.arange(orig_hw[1]) * w / orig_hw[1]).astype(int), 0, w - 1)
        return d[ys][:, xs]
