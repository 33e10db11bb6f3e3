"""DUSt3R-class two-view 3D reconstruction network (port of
``pyslam_tpu/models/dust3r.py``).

The CroCo v2 design: one ViT encoder shared by both views, two entangled
decoders with cross-attention to the other view's tokens, RoPE-2D in every
attention, and a linear pointmap head per view regressing each pixel's 3D
point (view 2's in view 1's frame, the exp depth-along-ray mode) and a
confidence ``1 + exp``.  The modules carry the official names
(``patch_embed.proj``, ``enc_blocks.N`` timm blocks, ``enc_norm``,
``decoder_embed``, ``dec_blocks.N`` / ``dec_blocks2.N``, ``dec_norm``,
``downstream_head{1,2}.proj``), so an official linear-head checkpoint loads
key for key (``torch_convert.dust3r_from_torch_file``).

LayerNorm is flax's (eps 1e-6, fast variance), GELU the exact erf form,
attention a plain product and softmax (float32, no TF32).  Without a
checkpoint the weights are seeded random ones (``trained = False``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import layer_norm, truncation_resample


# ------------------------------------------------------------------ RoPE 2D
def rope2d_freqs(positions: np.ndarray, dim: int, base: float = 100.0):
    """(N, 2) (y, x) token grid coordinates -> float32 cos / sin tables
    (N, dim / 2): the first half of a head's pairs rotates with y, the
    second with x (CroCo v2's RoPE2D).  Host numpy, so the card and the CPU
    use the same tables."""
    d4 = dim // 4
    inv = (1.0 / (np.float32(base) ** (np.arange(d4, dtype=np.float32) / np.float32(d4))))
    pos = np.asarray(positions, np.float32)
    ang = np.concatenate([pos[:, 0:1] * inv[None], pos[:, 1:2] * inv[None]], 1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """(..., H, N, D) tokens: rotate consecutive pairs."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).reshape(x.shape)


def _attend(q, k, v):
    """(..., H, N, d) softmax attention as the reference computes it."""
    att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), -1)
    return att @ v


def _heads_last(x: torch.Tensor) -> torch.Tensor:
    """(..., H, N, d) -> (..., N, H * d)."""
    return x.transpose(-3, -2).flatten(-2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """timm self-attention with a fused qkv and RoPE."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, cos, sin):          # (..., N, d)
        h = self.heads
        qkv = self.qkv(x).unflatten(-1, (3, h, -1))            # (..., N, 3, H, hd)
        q, k, v = (qkv[..., i, :, :].transpose(-3, -2) for i in range(3))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        return self.proj(_heads_last(_attend(q, k, v)))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, y, cos_q, sin_q, cos_k, sin_k):
        h = self.heads

        def split(t):
            return t.unflatten(-1, (h, -1)).transpose(-3, -2)

        q = apply_rope(split(self.projq(x)), cos_q, sin_q)
        k = apply_rope(split(self.projk(y)), cos_k, sin_k)
        return self.proj(_heads_last(_attend(q, k, split(self.projv(y)))))


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class EncBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = _ln(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, cos, sin):
        x = x + self.attn(layer_norm(self.norm1, x), cos, sin)
        return x + self.mlp(layer_norm(self.norm2, x))


class DecBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = _ln(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = _ln(dim)
        self.norm_y = _ln(dim)
        self.cross_attn = CrossAttention(dim, heads)
        self.norm3 = _ln(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, y, cos, sin, cos_y, sin_y):
        x = x + self.attn(layer_norm(self.norm1, x), cos, sin)
        x = x + self.cross_attn(layer_norm(self.norm2, x), layer_norm(self.norm_y, y),
                                cos, sin, cos_y, sin_y)
        return x + self.mlp(layer_norm(self.norm3, x))


@dataclass
class Dust3rConfig:
    img_hw: tuple = (224, 224)
    patch: int = 16
    enc_dim: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    dec_dim: int = 768
    dec_depth: int = 12
    dec_heads: int = 12


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class _Head(nn.Module):
    """``downstream_head{1,2}``: the linear pointmap head ``proj`` (and
    MASt3R's local-feature MLP, ``models.mast3r``)."""

    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = nn.Linear(dim, out)


class Dust3rNet(nn.Module):
    def __init__(self, cfg: Dust3rConfig):
        super().__init__()
        self.cfg = c = cfg
        self.patch_embed = _PatchEmbed(c.enc_dim, c.patch)
        self.enc_blocks = nn.ModuleList(EncBlock(c.enc_dim, c.enc_heads)
                                        for _ in range(c.enc_depth))
        self.enc_norm = _ln(c.enc_dim)
        self.decoder_embed = nn.Linear(c.enc_dim, c.dec_dim)
        self.dec_blocks = nn.ModuleList(DecBlock(c.dec_dim, c.dec_heads)
                                        for _ in range(c.dec_depth))
        self.dec_blocks2 = nn.ModuleList(DecBlock(c.dec_dim, c.dec_heads)
                                         for _ in range(c.dec_depth))
        self.dec_norm = _ln(c.dec_dim)
        self.downstream_head1 = _Head(c.dec_dim, c.patch * c.patch * 4)
        self.downstream_head2 = _Head(c.dec_dim, c.patch * c.patch * 4)
        h8, w8 = c.img_hw[0] // c.patch, c.img_hw[1] // c.patch
        ys, xs = np.meshgrid(np.arange(h8), np.arange(w8), indexing="ij")
        pos = np.stack([ys.ravel(), xs.ravel()], 1)
        for name, dim in (("enc", c.enc_dim // c.enc_heads), ("dec", c.dec_dim // c.dec_heads)):
            cos, sin = rope2d_freqs(pos, dim)
            self.register_buffer(f"cos_{name}", torch.from_numpy(cos), persistent=False)
            self.register_buffer(f"sin_{name}", torch.from_numpy(sin), persistent=False)

    def unshuffle(self, t: torch.Tensor, ch: int) -> torch.Tensor:
        """(N, p * p * ch) tokens -> (H, W, ch) pixels."""
        c = self.cfg
        h8, w8 = c.img_hw[0] // c.patch, c.img_hw[1] // c.patch
        t = t.reshape(h8, w8, c.patch, c.patch, ch)
        return t.permute(0, 2, 1, 3, 4).reshape(h8 * c.patch, w8 * c.patch, ch)

    def trunk(self, img1, img2):
        """(H, W, 3) images in [-1, 1] -> the encoder tokens (e1, e2) and
        the normalised decoder tokens (d1, d2)."""
        x = self.patch_embed.proj(torch.stack([img1, img2]).permute(0, 3, 1, 2))
        t = x.flatten(2).transpose(1, 2)                       # (2, N, enc_dim)
        for blk in self.enc_blocks:
            t = blk(t, self.cos_enc, self.sin_enc)
        e = layer_norm(self.enc_norm, t)
        d = self.decoder_embed(e)
        d1, d2 = d[0], d[1]
        cd, sd = self.cos_dec, self.sin_dec
        for b1, b2 in zip(self.dec_blocks, self.dec_blocks2):
            d1, d2 = b1(d1, d2, cd, sd, cd, sd), b2(d2, d1, cd, sd, cd, sd)
        return e[0], e[1], layer_norm(self.dec_norm, d1), layer_norm(self.dec_norm, d2)

    def pts_head(self, tokens, head: _Head):
        """Pointmap (H, W, 3), exp depth along the ray, and confidence."""
        out = self.unshuffle(head.proj(tokens), 4)
        pts = out[..., :3]
        d = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
        pts = pts / torch.clamp(d, min=1e-8) * torch.expm1(d)
        return pts, 1.0 + torch.exp(out[..., 3])

    def forward(self, img1, img2):
        """img: (H, W, 3) in [-1, 1].  Returns (pts1 (H, W, 3), conf1
        (H, W), pts2_in_1 (H, W, 3), conf2 (H, W))."""
        _, _, d1, d2 = self.trunk(img1, img2)
        return (*self.pts_head(d1, self.downstream_head1),
                *self.pts_head(d2, self.downstream_head2))


def prep_image(img, hw, always_8bit: bool) -> np.ndarray:
    """Grey or colour image -> (h, w, 3) float32 in [-1, 1], resampled by
    integer truncation (the reference's host code): DUSt3R divides by 255
    always (``always_8bit``), MASt3R only an image whose maximum passes 2."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    img = truncation_resample(img, hw)
    if always_8bit or img.max() > 2.0:
        img = img / 255.0
    return np.ascontiguousarray((img - 0.5) / 0.5, np.float32)


class Dust3rModel:
    """Two-view reconstruction on ``device`` at a fixed input size.
    ``checkpoint``: an official ``.pth`` / ``.pt`` or the JAX package's
    ``.npz``; without one seeded random weights (``trained = False``)."""

    net_class = Dust3rNet
    always_8bit = True

    def __init__(self, cfg: Dust3rConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or self.default_config()
        self.device = torch.device(device)
        self.net = self.net_class(self.cfg)
        self.trained = False
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    @staticmethod
    def default_config():
        return Dust3rConfig()

    def load_checkpoint(self, path: str):
        if str(path).endswith((".pth", ".pt")):
            from pyslam_tpu_torch.models.torch_convert import dust3r_from_torch_file

            sd = dust3r_from_torch_file(path)
        else:
            sd = interop.dust3r_state_dict(interop.read_npz(path))
        self.net.load_state_dict(sd)
        self.trained = True

    def _prep(self, img) -> torch.Tensor:
        return torch.from_numpy(prep_image(img, self.cfg.img_hw, self.always_8bit)).to(self.device)

    def infer_pair(self, img1, img2):
        """uint8 / float images (H, W[, 3]) -> (pts1, conf1, pts2_in_1,
        conf2) on the device."""
        with torch.no_grad():
            return self.net(self._prep(img1), self._prep(img2))
