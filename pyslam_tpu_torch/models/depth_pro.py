"""DepthPro-class multi-scale ViT monocular metric depth (port of
``pyslam_tpu/models/depth_pro.py``).

The square working image is resampled to three scales (full, 1/2, 1/4;
``jax.image.resize``'s antialiased weights, ``layers.resize_hw``), each
split into overlapping ``patch_px`` patches at host-computed origins
(``_patch_positions``; the 1/4 scale is one patch).  One shared ViT
(``PatchViT``, VGGT blocks) encodes every patch of every scale in one
batch, a second ViT the whole image resampled to one patch (global
context).  Each scale's patch grids are stitched with their overlaps
averaged, in the reference's order of adds; a DPT fusion decoder
(``depth_anything_v2.FusionBlock``) combines the global features with the
three scales and predicts canonical inverse depth (softplus), and a FOV
head on the pooled global and decoder features predicts the horizontal
field of view.  Metric depth is ``f_px / (W * canonical_inv)``, ``f_px``
from the FOV or the calibrated camera.  The modules carry the JAX
package's names.  Without a checkpoint (the JAX package's ``.npz``) the
weights are seeded random ones (``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.depth_anything_v2 import FusionBlock
from pyslam_tpu_torch.models.layers import autotuned_convs, layer_norm, resize_hw, softplus
from pyslam_tpu_torch.models.vggt import _Block


@dataclass(frozen=True)
class DepthProConfig:
    img_px: int = 1536          # working resolution (square)
    patch_px: int = 384         # patch encoder input size
    overlap: float = 0.25       # patch overlap fraction
    vit_patch: int = 16
    dim: int = 384
    depth: int = 12
    heads: int = 6
    features: int = 64          # fusion width


def _patch_positions(S: int, P: int, overlap: float):
    """Evenly spaced patch origins covering [0, S - P] (host ints)."""
    if S <= P:
        return [0]
    stride = int(P * (1.0 - overlap))
    n = int(np.ceil((S - P) / stride)) + 1
    return [int(round(p)) for p in np.linspace(0, S - P, n)]


class PatchViT(nn.Module):
    """A ViT over (B, 3, P, P) patches -> (B, g, g, dim) grids."""

    def __init__(self, cfg: DepthProConfig):
        super().__init__()
        self.cfg = c = cfg
        g = c.patch_px // c.vit_patch
        self.patch_embed = nn.Conv2d(3, c.dim, c.vit_patch, stride=c.vit_patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, g * g, c.dim))
        for i in range(c.depth):
            self.add_module(f"block_{i}", _Block(c.dim, c.heads))
        self.norm = nn.LayerNorm(c.dim, eps=1e-6)

    def forward(self, x):
        c = self.cfg
        g = c.patch_px // c.vit_patch
        t = self.patch_embed(x).flatten(2).transpose(1, 2) + self.pos_embed
        for i in range(c.depth):
            t = getattr(self, f"block_{i}")(t)
        return layer_norm(self.norm, t).reshape(x.shape[0], g, g, c.dim)


class DepthProNet(nn.Module):
    def __init__(self, cfg: DepthProConfig):
        super().__init__()
        self.cfg = c = cfg
        self.patch_encoder = PatchViT(c)
        self.image_encoder = PatchViT(c)
        for name in ("proj_glob", "proj_low", "proj_mid", "proj_hi"):
            self.add_module(name, nn.Conv2d(c.dim, c.features, 1))
        self.refine4 = FusionBlock(c.features)
        self.refine3 = FusionBlock(c.features)
        self.refine2 = FusionBlock(c.features)
        self.head_conv1 = nn.Conv2d(c.features, c.features // 2, 3, padding=1)
        self.head_conv2 = nn.Conv2d(c.features // 2, 32, 3, padding=1)
        self.head_out = nn.Conv2d(32, 1, 1)
        self.fov_fc1 = nn.Linear(c.dim + c.features, 64)
        self.fov_fc2 = nn.Linear(64, 1)

    def layout(self):
        """[(scale side, patch origins)] of the three scales."""
        c = self.cfg
        return [(c.img_px // s, _patch_positions(c.img_px // s, c.patch_px, c.overlap))
                for s in (1, 2, 4)]

    def stitch(self, feats, size: int, pos):
        """One scale's patch grids (n, g, g, dim) -> its (gs, gs, dim) grid,
        overlaps averaged (the reference's order of adds)."""
        c = self.cfg
        g = c.patch_px // c.vit_patch
        gs = size // c.vit_patch
        acc = feats.new_zeros((gs, gs, c.dim))
        wacc = feats.new_zeros((gs, gs, 1))
        i = 0
        for gy in (p // c.vit_patch for p in pos):
            for gx in (p // c.vit_patch for p in pos):
                acc[gy:gy + g, gx:gx + g] += feats[i]
                wacc[gy:gy + g, gx:gx + g] += 1.0
                i += 1
        return acc / torch.clamp(wacc, min=1.0)

    def forward(self, img):                  # (3, S, S) in [-1, 1]
        c = self.cfg
        S, P = c.img_px, c.patch_px
        layout = self.layout()
        patches = []
        for size, pos in layout:
            im = img if size == S else resize_hw(img, (size, size))
            patches += [im[:, y0:y0 + P, x0:x0 + P] for y0 in pos for x0 in pos]
        feats = self.patch_encoder(torch.stack(patches))
        glob = self.image_encoder(resize_hw(img, (P, P))[None])[0]
        stitched, off = [], 0
        for size, pos in layout:
            n = len(pos) ** 2
            stitched.append(self.stitch(feats[off:off + n], size, pos))
            off += n
        hi, mid, low = stitched      # grids S/16, S/32, S/64

        def proj(x, name):
            return getattr(self, name)(x.permute(2, 0, 1)[None])

        with autotuned_convs():
            f_glob, f_low = proj(glob, "proj_glob"), proj(low, "proj_low")
            f_mid, f_hi = proj(mid, "proj_mid"), proj(hi, "proj_hi")
            p4 = self.refine4(f_glob, f_low, out_hw=f_mid.shape[-2:])
            p3 = self.refine3(p4, f_mid, out_hw=f_hi.shape[-2:])
            p2 = self.refine2(p3, f_hi)                          # S/8
            y = resize_hw(self.head_conv1(p2), (S, S))
            y = self.head_out(F.relu(self.head_conv2(y)))
        canonical_inv = softplus(y[0, 0])
        fhead = torch.cat([glob.mean(dim=(0, 1)), p2[0].mean(dim=(1, 2))])
        fov = self.fov_fc2(F.gelu(self.fov_fc1(fhead)))[0]
        return canonical_inv, 30.0 + 60.0 * torch.sigmoid(fov)


class DepthPro:
    """Image -> (metric depth, f_px) on ``device``."""

    def __init__(self, cfg: DepthProConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or DepthProConfig()
        self.device = torch.device(device)
        self.net = DepthProNet(self.cfg)
        self.trained = False
        if checkpoint:
            self.net.load_state_dict(interop.depth_pro_state_dict(interop.read_npz(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def prepare(self, img) -> np.ndarray:
        """(H, W[, 3]) -> the (3, S, S) working image in [-1, 1] (host)."""
        img = np.asarray(img, np.float32)
        H, W = img.shape[:2]
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        S = self.cfg.img_px
        ys = np.clip((np.arange(S) * H / S).astype(int), 0, H - 1)
        xs = np.clip((np.arange(S) * W / S).astype(int), 0, W - 1)
        x = img[np.ix_(ys, xs)]
        if x.max() > 2.0:
            x = x / 255.0
        x = (x - 0.5) / 0.5
        return np.ascontiguousarray(x.transpose(2, 0, 1), np.float32)

    def run(self, x: np.ndarray):
        with torch.no_grad():
            return self.net(torch.from_numpy(x).to(self.device))

    def infer(self, img, f_px: float | None = None):
        """(H, W[, 3]) [0, 255] -> (metric depth (H, W), f_px); ``f_px``
        (the focal in px at the original width) overrides the FOV head's."""
        H, W = np.asarray(img).shape[:2]
        S = self.cfg.img_px
        cinv, fov_deg = self.run(self.prepare(img))
        cinv = cinv.cpu().numpy()
        fov_deg = float(fov_deg)
        if f_px is None:
            f_px = 0.5 * W / np.tan(0.5 * np.radians(fov_deg))
        inv = cinv * (W / f_px)
        depth = 1.0 / np.maximum(inv, 1e-4)
        ys = np.clip((np.arange(H) * S / H).astype(int), 0, S - 1)
        xs = np.clip((np.arange(W) * S / W).astype(int), 0, S - 1)
        return depth[np.ix_(ys, xs)].astype(np.float32), f_px
