"""DepthAnythingV2's ViT building block (port of the ``ViTBlock`` of
``pyslam_tpu/models/depth_anything_v2.py``).

The DINOv2 block: pre-LayerNorm self-attention with a fused qkv and
LayerScale, then a pre-LayerNorm MLP (exact-erf GELU) with LayerScale;
LayerNorm as flax computes it (eps 1e-6, fast variance).  MegaLoc's ViT
(``models.megaloc``) is built from it.  The rest of DepthAnythingV2 (the
DPT head and the estimator) comes with the learned depth estimators
(ROADMAP.md item 3.3).  The modules carry the JAX package's names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch.models.dust3r import _attend, _heads_last
from pyslam_tpu_torch.models.layers import layer_norm


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
