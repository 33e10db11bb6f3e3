"""MegaLoc-class place-recognition descriptor: a ViT and SALAD aggregation
(port of ``pyslam_tpu/models/megaloc.py``).

A DINOv2-class ViT (``models.depth_anything_v2.ViTBlock``; a learned
position embedding and a class token) whose patch tokens SALAD aggregates:
a score head gives each token a logit per cluster and a dustbin (the last
column), a log-domain Sinkhorn (``sinkhorn``) turns the scores into a
transport plan, and each cluster's descriptor is the plan-weighted sum of
the tokens' projected features, intra-normalised; the projected class
token comes first, then a global L2.  The modules carry the JAX package's
names.  Without a checkpoint (the JAX package's ``.npz``) the weights are
seeded random ones (``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.depth_anything_v2 import ViTBlock
from pyslam_tpu_torch.models.layers import imagenet_square, layer_norm


@dataclass(frozen=True)
class MegaLocConfig:
    img_px: int = 224
    patch: int = 14
    dim: int = 384
    depth: int = 6
    heads: int = 6
    clusters: int = 64
    cluster_dim: int = 128
    token_dim: int = 256      # projected global token size
    sinkhorn_iters: int = 3


def sinkhorn(scores: torch.Tensor, iters: int) -> torch.Tensor:
    """Log-domain Sinkhorn over (N, K + 1) scores, the last column the
    dustbin: each round balances the K cluster columns to N / K mass (the
    dustbin is free), then normalises every row (token) to unit mass."""
    log_p = scores
    bal = float(np.float32(np.log(scores.shape[0] / (scores.shape[1] - 1))))
    for _ in range(iters):
        col = torch.logsumexp(log_p[:, :-1], 0, keepdim=True)
        log_p = torch.cat([log_p[:, :-1] + (-col + bal), log_p[:, -1:]], 1)
        log_p = log_p - torch.logsumexp(log_p, 1, keepdim=True)
    return torch.exp(log_p)


class MegaLocNet(nn.Module):
    def __init__(self, cfg: MegaLocConfig):
        super().__init__()
        self.cfg = c = cfg
        g = c.img_px // c.patch
        self.patch_embed = nn.Conv2d(3, c.dim, c.patch, stride=c.patch)
        self.cls_token = nn.Parameter(torch.zeros(1, c.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1 + g * g, c.dim))
        for i in range(c.depth):
            self.add_module(f"block_{i}", ViTBlock(c.dim, c.heads))
        self.norm = nn.LayerNorm(c.dim, eps=1e-6)
        self.cluster_features = nn.Linear(c.dim, c.cluster_dim)
        self.score = nn.Linear(c.dim, c.clusters + 1)
        self.token_proj = nn.Linear(c.dim, c.token_dim)

    def forward(self, img):                  # (S, S, 3) ImageNet-normalised
        c = self.cfg
        tokens = self.patch_embed(img.permute(2, 0, 1)[None]).flatten(2)[0].T
        t = torch.cat([self.cls_token, tokens], 0) + self.pos_embed
        for i in range(c.depth):
            t = getattr(self, f"block_{i}")(t)
        t = layer_norm(self.norm, t)
        glob, patches = t[0], t[1:]
        feat = self.cluster_features(patches)
        plan = sinkhorn(self.score(patches), c.sinkhorn_iters)[:, :-1]      # (N, K)
        agg = torch.einsum("nk,nd->kd", plan, feat)
        agg = agg / torch.clamp(torch.linalg.vector_norm(agg, dim=1, keepdim=True), min=1e-9)
        out = torch.cat([self.token_proj(glob), agg.reshape(-1)])
        return out / torch.clamp(torch.linalg.vector_norm(out), min=1e-9)


class MegaLocExtractor:
    """Whole image -> global descriptor (host array), computed on
    ``device``; the surface of ``NetVLADExtractor`` / ``CosPlaceExtractor``."""

    def __init__(self, cfg: MegaLocConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or MegaLocConfig()
        self.device = torch.device(device)
        self.net = MegaLocNet(self.cfg)
        self.trained = False
        if checkpoint:
            self.net.load_state_dict(interop.megaloc_state_dict(interop.read_npz(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    @property
    def dim(self) -> int:
        return self.cfg.token_dim + self.cfg.clusters * self.cfg.cluster_dim

    def prepare(self, img) -> np.ndarray:
        """Host pre-processing, the reference's (``layers.imagenet_square``)."""
        return imagenet_square(img, self.cfg.img_px)

    def describe(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.net(x)

    def __call__(self, img) -> np.ndarray:
        return self.describe(torch.from_numpy(self.prepare(img)).to(self.device)).cpu().numpy()
