"""VGGT's transformer block (port of the ``_Block`` of
``pyslam_tpu/models/vggt.py``).

A pre-LayerNorm ViT block: self-attention over the second-last axis with a
fused qkv (q, k, v in that order along the output), then a pre-LayerNorm
MLP with the exact-erf GELU; no LayerScale.  LayerNorm as flax computes it
(eps 1e-6, fast variance).  DepthAnything 3 (``models.depth_anything_v3``)
and DepthPro (``models.depth_pro``) are built from it.  The rest of VGGT
comes with the 3D reconstruction models (ROADMAP.md item 3.5).  The
modules carry the JAX package's names.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch.models.dust3r import _attend, _heads_last
from pyslam_tpu_torch.models.layers import layer_norm


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

    def forward(self, x):                    # (..., N, D)
        qkv = self.qkv(layer_norm(self.norm1, x)).unflatten(-1, (3, self.heads, -1))
        q, k, v = (qkv[..., i, :, :].transpose(-3, -2) for i in range(3))
        x = x + self.proj(_heads_last(_attend(q, k, v)))
        return x + self.fc2(F.gelu(self.fc1(layer_norm(self.norm2, x))))
