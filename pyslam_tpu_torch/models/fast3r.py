"""Fast3R-class multi-view reconstruction (port of
``pyslam_tpu/models/fast3r.py``).

A per-image ViT encoder (attention within each view), a global fusion
decoder over all views' tokens with a learned image-index embedding per
view, and two linear pixel-shuffle heads per view: a global pointmap in
view 0's frame and a local one in the view's own frame, each with a
confidence.  The blocks are VGGT's ``_Block``; the modules carry the JAX
package's names (``interop.fast3r_state_dict``); without a checkpoint the
weights are seeded random ones (``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import layer_norm
from pyslam_tpu_torch.models.vggt import _Block, prep_views, unshuffle_points


@dataclass
class Fast3RConfig:
    img_hw: tuple = (224, 224)
    patch: int = 16
    enc_dim: int = 768
    enc_depth: int = 12
    enc_heads: int = 12
    dec_dim: int = 768
    dec_depth: int = 12
    dec_heads: int = 12
    max_views: int = 64  # index-embedding pool


class Fast3RNet(nn.Module):
    def __init__(self, cfg: Fast3RConfig):
        super().__init__()
        self.cfg = c = cfg
        n = (c.img_hw[0] // c.patch) * (c.img_hw[1] // c.patch)
        self.patch_embed = nn.Conv2d(3, c.enc_dim, c.patch, stride=c.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, n, c.enc_dim))
        for i in range(c.enc_depth):
            self.add_module(f"enc_{i}", _Block(c.enc_dim, c.enc_heads))
        self.enc_norm = nn.LayerNorm(c.enc_dim, eps=1e-6)
        self.decoder_embed = nn.Linear(c.enc_dim, c.dec_dim)
        self.image_index_embed = nn.Parameter(torch.zeros(c.max_views, c.dec_dim))
        for i in range(c.dec_depth):
            self.add_module(f"dec_{i}", _Block(c.dec_dim, c.dec_heads))
        self.dec_norm = nn.LayerNorm(c.dec_dim, eps=1e-6)
        self.head_global = nn.Linear(c.dec_dim, c.patch * c.patch * 4)
        self.head_local = nn.Linear(c.dec_dim, c.patch * c.patch * 4)

    def forward(self, imgs):                 # (V, H, W, 3) in [-1, 1]
        """-> (global points (V, H, W, 3), conf (V, H, W), local points,
        local conf)."""
        c = self.cfg
        V = imgs.shape[0]
        if V > c.max_views:
            # the reference fails on the index embedding's shape
            raise ValueError(f"{V} views, the index embedding holds {c.max_views}")
        hp, wp = c.img_hw[0] // c.patch, c.img_hw[1] // c.patch
        t = self.patch_embed(imgs.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        t = t + self.pos_embed
        for i in range(c.enc_depth):          # attention within each view
            t = getattr(self, f"enc_{i}")(t)
        t = self.decoder_embed(layer_norm(self.enc_norm, t))
        t = t + self.image_index_embed[:V][:, None, :]
        flat = t.reshape(1, -1, c.dec_dim)
        for i in range(c.dec_depth):          # attention across all views
            flat = getattr(self, f"dec_{i}")(flat)
        t = layer_norm(self.dec_norm, flat).reshape(V, -1, c.dec_dim)
        return (*unshuffle_points(self.head_global(t), hp, wp, c.patch),
                *unshuffle_points(self.head_local(t), hp, wp, c.patch))


class Fast3RModel:
    """Multi-view facade on ``device``: all frames in one forward pass."""

    def __init__(self, cfg: Fast3RConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or Fast3RConfig()
        self.device = torch.device(device)
        self.net = Fast3RNet(self.cfg)
        self.trained = False
        if checkpoint:
            self.net.load_state_dict(interop.fast3r_state_dict(interop.read_npz(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def run(self, images: list):
        """The network's outputs on the device."""
        with torch.no_grad():
            return self.net(torch.from_numpy(prep_views(images, self.cfg.img_hw)).to(self.device))

    def infer_views(self, images: list) -> dict:
        """-> dict(points (V, H, W, 3) in view 0's frame, conf, local_points
        in each view's frame, local_conf), host arrays."""
        g_pts, g_conf, l_pts, l_conf = (o.cpu().numpy() for o in self.run(images))
        return {"points": g_pts, "conf": g_conf, "local_points": l_pts, "local_conf": l_conf}
