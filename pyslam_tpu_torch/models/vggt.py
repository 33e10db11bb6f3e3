"""VGGT-class multi-view feed-forward reconstruction (port of
``pyslam_tpu/models/vggt.py``).

Per-frame patch embedding with a learnable camera token prepended to each
frame's tokens, then alternating pairs of pre-LayerNorm ViT blocks: the
frame block attends within each image, the global block across the
concatenation of all images' tokens.  The global block's softmax
probabilities give each view's mean attention mass toward view 0 (the
anchor of Robust-VGGT's outlier-view test), accumulated over depth.  A
camera head on each camera token regresses a unit quaternion, a
translation and ``softplus + 0.2`` fov; a linear pixel-shuffle head on the
patch tokens regresses each pixel's 3D point (exp depth along the ray) and
a confidence ``1 + exp(clip(., -10, 10))``.

``_Block`` is also the block of DepthAnything 3 (``models.depth_anything_v3``),
DepthPro (``models.depth_pro``) and Fast3R (``models.fast3r``).  LayerNorm
as flax computes it (eps 1e-6, fast variance), the exact-erf GELU, attention
a plain float32 product and softmax: the anchor mass needs the global
block's probabilities, so no fused attention.  The modules carry the JAX
package's names (``interop.vggt_state_dict``); without a checkpoint the
weights are seeded random ones (``trained = False``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.dust3r import _attend, _heads_last, prep_image
from pyslam_tpu_torch.models.layers import layer_norm, softplus


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x, return_attn: bool = False):    # (..., N, D)
        """With ``return_attn`` also the softmax probabilities (..., H, N, N)."""
        qkv = self.qkv(layer_norm(self.norm1, x)).unflatten(-1, (3, self.heads, -1))
        q, k, v = (qkv[..., i, :, :].transpose(-3, -2) for i in range(3))
        if return_attn:
            attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), -1)
            o = attn @ v
        else:
            o = _attend(q, k, v)
        x = x + self.proj(_heads_last(o))
        x = x + self.fc2(F.gelu(self.fc1(layer_norm(self.norm2, x))))
        return (x, attn) if return_attn else x


def unshuffle_points(out: torch.Tensor, hp: int, wp: int, patch: int):
    """Linear pixel-shuffle head output (V, N, p * p * 4) -> the pointmap
    (V, H, W, 3), exp depth along the ray, and its confidence (V, H, W)."""
    V = out.shape[0]
    out = out.reshape(V, hp, wp, patch, patch, 4).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(V, hp * patch, wp * patch, 4)
    pts = out[..., :3]
    d = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
    pts = pts / torch.clamp(d, min=1e-8) * torch.expm1(d)
    return pts, 1.0 + torch.exp(torch.clamp(out[..., 3], -10, 10))


@dataclass
class VGGTConfig:
    img_hw: tuple = (224, 224)
    patch: int = 16
    dim: int = 768
    depth_pairs: int = 12   # alternating (frame, global) block pairs
    heads: int = 12


class VGGTNet(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = c = cfg
        n = (c.img_hw[0] // c.patch) * (c.img_hw[1] // c.patch)
        self.patch_embed = nn.Conv2d(3, c.dim, c.patch, stride=c.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, n, c.dim))
        self.camera_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        for i in range(c.depth_pairs):
            self.add_module(f"frame_{i}", _Block(c.dim, c.heads))
            self.add_module(f"global_{i}", _Block(c.dim, c.heads))
        self.norm = nn.LayerNorm(c.dim, eps=1e-6)
        self.cam_fc1 = nn.Linear(c.dim, c.dim)
        self.cam_fc2 = nn.Linear(c.dim, 8)
        self.point_head = nn.Linear(c.dim, c.patch * c.patch * 4)

    def forward(self, imgs):                 # (V, H, W, 3) in [-1, 1]
        """-> (points (V, H, W, 3), conf (V, H, W), quat (V, 4), trans
        (V, 3), fov (V,), anchor mass (V,))."""
        c = self.cfg
        V = imgs.shape[0]
        hp, wp = c.img_hw[0] // c.patch, c.img_hw[1] // c.patch
        n = hp * wp
        t = self.patch_embed(imgs.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        t = t + self.pos_embed
        t = torch.cat([self.camera_token.expand(V, 1, c.dim), t], 1)      # (V, N + 1, D)
        mass = torch.zeros(V, dtype=t.dtype, device=t.device)
        for i in range(c.depth_pairs):
            t = getattr(self, f"frame_{i}")(t)
            flat, attn = getattr(self, f"global_{i}")(t.reshape(1, V * (n + 1), c.dim),
                                                      return_attn=True)
            # each view's mean attention mass into view 0's tokens
            per_q = attn[0].mean(0)[:, : n + 1].sum(-1)
            mass = mass + per_q.reshape(V, n + 1).mean(1)
            t = flat.reshape(V, n + 1, c.dim)
        t = layer_norm(self.norm, t)
        cam, patches = t[:, 0], t[:, 1:]
        enc = self.cam_fc2(F.gelu(self.cam_fc1(cam)))
        quat = enc[:, :4] / torch.clamp(torch.linalg.vector_norm(enc[:, :4], dim=1, keepdim=True),
                                        min=1e-6)
        fov = softplus(enc[:, 7]) + 0.2
        pts, conf = unshuffle_points(self.point_head(patches), hp, wp, c.patch)
        return pts, conf, quat, enc[:, 4:7], fov, mass / c.depth_pairs


def _quat_to_R(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def prep_views(images: list, hw) -> np.ndarray:
    """Grey or colour images -> (V, h, w, 3) float32 in [-1, 1] (the
    reference's host code: nearest sampling at ``floor(i * H / h)``,
    divided by 255 when the image's maximum passes 2)."""
    return np.stack([prep_image(img, hw, always_8bit=False) for img in images])


class VGGTModel:
    """Multi-view facade on ``device``: all frames in one forward pass."""

    def __init__(self, cfg: VGGTConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or VGGTConfig()
        self.device = torch.device(device)
        self.net = VGGTNet(self.cfg)
        self.trained = False
        if checkpoint:
            self.net.load_state_dict(interop.vggt_state_dict(interop.read_npz(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def run(self, images: list):
        """The network's outputs on the device."""
        with torch.no_grad():
            return self.net(torch.from_numpy(prep_views(images, self.cfg.img_hw)).to(self.device))

    def infer_views(self, images: list) -> dict:
        """-> dict(points (V, H, W, 3), conf, poses (V, 4, 4) camera-to-
        view-0, fov (V,), anchor_mass (V,)), host arrays."""
        pts, conf, quat, trans, fov, mass = (o.cpu().numpy() for o in self.run(images))
        V = len(images)
        poses = np.tile(np.eye(4), (V, 1, 1))
        poses[:, :3, :3] = _quat_to_R(quat)
        poses[:, :3, 3] = trans
        # gauge fix: everything relative to view 0
        poses = np.einsum("ij,vjk->vik", np.linalg.inv(poses[0]), poses)
        return {"points": pts, "conf": conf, "poses": poses, "fov": fov, "anchor_mass": mass}
