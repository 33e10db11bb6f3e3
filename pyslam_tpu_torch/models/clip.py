"""CLIP-class dual encoder: a ViT image tower and a causal text
transformer (port of ``pyslam_tpu/models/clip.py``).

- Image tower: a patch convolution (no bias), a class token, a learned
  position embedding, a pre-LayerNorm, ``vggt._Block`` blocks, a final
  LayerNorm and a linear projection ``proj`` to the shared space.  The
  class token gives the global embedding; the patch tokens through the same
  projection give the dense (g, g, D) map open-vocabulary segmentation
  reads.
- Text tower: the byte-level ``tokenize`` (lower-cased UTF-8 bytes between
  SOT and EOT, padded), a token and position embedding, pre-LN causal
  blocks (the -1e9 mask, the exact-erf GELU), a final LayerNorm, the
  features at the first EOT token, projected.

``CLIPModel`` normalises both embeddings on the host, as the reference
does; ``_prep`` resamples the image to the tower's square by
``floor(i * H / S)`` and normalises with float64 constants before the
float32 cast.  The modules carry the JAX package's names; a checkpoint is
the JAX package's pair ``<path>.image.npz`` / ``<path>.text.npz``
(``interop.clip_state_dict``).  Without one the weights are seeded random
ones (``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import layer_norm, truncation_resample
from pyslam_tpu_torch.models.vggt import _Block


@dataclass(frozen=True)
class CLIPConfig:
    img_px: int = 224
    vit_patch: int = 16
    vit_dim: int = 384
    vit_depth: int = 6
    vit_heads: int = 6
    text_dim: int = 256
    text_depth: int = 4
    text_heads: int = 4
    context: int = 32          # max text tokens
    embed_dim: int = 256       # shared space
    vocab: int = 260           # 256 bytes + pad/sot/eot/unk


SOT, EOT, PAD = 256, 257, 258


def tokenize(texts, context: int = 32) -> np.ndarray:
    """Byte-level tokenizer: (B, context) int32."""
    out = np.full((len(texts), context), PAD, np.int32)
    for i, t in enumerate(texts):
        b = list(t.lower().strip().encode("utf-8"))[: context - 2]
        out[i, 0] = SOT
        out[i, 1:1 + len(b)] = b
        out[i, 1 + len(b)] = EOT
    return out


class CLIPImageTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = c = cfg
        g = c.img_px // c.vit_patch
        self.patch_embed = nn.Conv2d(3, c.vit_dim, c.vit_patch, stride=c.vit_patch, bias=False)
        self.cls = nn.Parameter(torch.zeros(1, 1, c.vit_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, g * g + 1, c.vit_dim))
        self.pre_norm = nn.LayerNorm(c.vit_dim, eps=1e-6)
        for i in range(c.vit_depth):
            self.add_module(f"block_{i}", _Block(c.vit_dim, c.vit_heads))
        self.post_norm = nn.LayerNorm(c.vit_dim, eps=1e-6)
        self.proj = nn.Parameter(torch.zeros(c.vit_dim, c.embed_dim))

    def forward(self, img):                  # (S, S, 3) normalised
        c = self.cfg
        g = c.img_px // c.vit_patch
        t = self.patch_embed(img.permute(2, 0, 1)[None]).flatten(2).transpose(1, 2)
        t = torch.cat([self.cls, t], 1)
        t = layer_norm(self.pre_norm, t + self.pos_embed)
        for i in range(c.vit_depth):
            t = getattr(self, f"block_{i}")(t)
        t = layer_norm(self.post_norm, t)
        return t[0, 0] @ self.proj, (t[0, 1:] @ self.proj).reshape(g, g, c.embed_dim)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = c = cfg
        d = c.text_dim
        self.token_embed = nn.Embedding(c.vocab, d)
        self.pos_embed = nn.Parameter(torch.zeros(1, c.context, d))
        for i in range(c.text_depth):
            self.add_module(f"block_{i}_norm1", nn.LayerNorm(d, eps=1e-6))
            self.add_module(f"block_{i}_qkv", nn.Linear(d, 3 * d))
            self.add_module(f"block_{i}_proj", nn.Linear(d, d))
            self.add_module(f"block_{i}_norm2", nn.LayerNorm(d, eps=1e-6))
            self.add_module(f"block_{i}_fc1", nn.Linear(d, 4 * d))
            self.add_module(f"block_{i}_fc2", nn.Linear(4 * d, d))
        self.final_norm = nn.LayerNorm(d, eps=1e-6)
        self.proj = nn.Parameter(torch.zeros(d, c.embed_dim))

    def forward(self, tokens):               # (B, L) int
        c = self.cfg
        B, L = tokens.shape
        hd = c.text_dim // c.text_heads
        x = self.token_embed(tokens) + self.pos_embed[:, :L]
        causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=tokens.device))
        neg = torch.full((), -1e9, dtype=x.dtype, device=x.device)
        for i in range(c.text_depth):
            def m(name):
                return getattr(self, f"block_{i}_{name}")

            qkv = m("qkv")(layer_norm(m("norm1"), x)).reshape(B, L, 3, c.text_heads, hd)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))     # (B, h, L, hd)
            att = torch.where(causal, q @ k.transpose(-1, -2) / np.sqrt(hd), neg)
            o = (torch.softmax(att, -1) @ v).transpose(1, 2).reshape(B, L, c.text_dim)
            x = x + m("proj")(o)
            x = x + m("fc2")(F.gelu(m("fc1")(layer_norm(m("norm2"), x))))
        x = layer_norm(self.final_norm, x)
        eot = torch.argmax((tokens == EOT).to(torch.int32), 1)
        return x[torch.arange(B, device=x.device), eot] @ self.proj


_CLIP_MEAN = np.array([0.481, 0.457, 0.408])
_CLIP_STD = np.array([0.268, 0.261, 0.275])


class CLIPModel:
    """``encode_image`` / ``encode_text`` (unit host embeddings), the
    towers on ``device``."""

    def __init__(self, cfg: CLIPConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or CLIPConfig()
        self.device = torch.device(device)
        self.image = CLIPImageTower(self.cfg)
        self.text = CLIPTextTower(self.cfg)
        self.logit_scale = 100.0
        self.trained = False
        if checkpoint:
            for tower, part in ((self.image, "image"), (self.text, "text")):
                tower.load_state_dict(interop.clip_state_dict(
                    interop.read_npz(f"{checkpoint}.{part}.npz")))
            self.trained = True
        else:
            interop.seeded_init_(self.image, 0)
            interop.seeded_init_(self.text, 1)
        self.image.to(self.device).eval()
        self.text.to(self.device).eval()

    def _prep(self, img) -> np.ndarray:
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        S = self.cfg.img_px
        x = truncation_resample(img, (S, S))
        if x.max() > 2.0:
            x = x / 255.0
        return np.ascontiguousarray((x - _CLIP_MEAN) / _CLIP_STD, np.float32)

    def image_embeddings(self, x: np.ndarray):
        """Prepared (S, S, 3) image -> (global (D,), patch (g, g, D)) raw
        embeddings on the device."""
        with torch.no_grad():
            return self.image(torch.from_numpy(x).to(self.device))

    def encode_image(self, img, dense: bool = False):
        """-> the unit global embedding (D,), or (global, patches (g, g, D))."""
        g, p = self.image_embeddings(self._prep(img))
        g = g.cpu().numpy()
        g = g / max(np.linalg.norm(g), 1e-9)
        if not dense:
            return g
        p = p.cpu().numpy()
        return g, p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)

    def encode_text(self, texts: list) -> np.ndarray:
        toks = torch.from_numpy(tokenize(texts, self.cfg.context)).to(self.device)
        with torch.no_grad():
            e = self.text(toks.to(torch.int64)).cpu().numpy()
        return e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-9)
