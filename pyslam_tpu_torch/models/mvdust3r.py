"""MV-DUSt3R(+)-class single-stage multi-view reconstruction (port of
``pyslam_tpu/models/mvdust3r.py``).

A shared RoPE-2D ViT encoder over every view (``dust3r.EncBlock``), then a
multi-view decoder with view 0 as the reference: in each layer the
reference self-attends and cross-attends into the concatenation of the
source views' tokens, and every source (one weight-shared block over the
batch of sources) cross-attends into the reference and all sources, each
from the layer's input tokens (``dust3r.DecBlock``).  Two linear heads per
view give a global pointmap in the reference frame and a local one in the
view's own frame, each with a confidence ``1 + exp(clip(c, -10, 10))``.
``MVDust3rModel.infer_views`` tries ``num_refs`` reference views (the "+"
variant keeps the most confident) and recovers each view's pose by
Umeyama from its local to its global points (``evaluation.metrics.
umeyama_np``).  The modules carry the JAX package's names.  Without a
checkpoint (the JAX package's ``.npz``) the weights are seeded random ones
(``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.evaluation.metrics import umeyama_np
from pyslam_tpu_torch.models.dust3r import DecBlock, EncBlock, prep_image, rope2d_freqs
from pyslam_tpu_torch.models.layers import layer_norm


@dataclass(frozen=True)
class MVDust3rConfig:
    img_hw: tuple = (224, 224)
    patch: int = 16
    enc_dim: int = 384
    enc_depth: int = 6
    enc_heads: int = 6
    dec_dim: int = 384
    dec_depth: int = 6
    dec_heads: int = 6


class MVDust3rNet(nn.Module):
    def __init__(self, cfg: MVDust3rConfig):
        super().__init__()
        self.cfg = c = cfg
        self.patch_embed = nn.Conv2d(3, c.enc_dim, c.patch, stride=c.patch)
        for i in range(c.enc_depth):
            self.add_module(f"enc_{i}", EncBlock(c.enc_dim, c.enc_heads))
        self.enc_norm = nn.LayerNorm(c.enc_dim, eps=1e-6)
        self.decoder_embed = nn.Linear(c.enc_dim, c.dec_dim)
        for i in range(c.dec_depth):
            self.add_module(f"dec_ref_{i}", DecBlock(c.dec_dim, c.dec_heads))
            self.add_module(f"dec_src_{i}", DecBlock(c.dec_dim, c.dec_heads))
        self.dec_norm = nn.LayerNorm(c.dec_dim, eps=1e-6)
        self.head_global = nn.Linear(c.dec_dim, c.patch * c.patch * 4)
        self.head_local = nn.Linear(c.dec_dim, c.patch * c.patch * 4)
        h8, w8 = c.img_hw[0] // c.patch, c.img_hw[1] // c.patch
        ys, xs = np.meshgrid(np.arange(h8), np.arange(w8), indexing="ij")
        pos = np.stack([ys.ravel(), xs.ravel()], 1)
        for name, dim in (("enc", c.enc_dim // c.enc_heads), ("dec", c.dec_dim // c.dec_heads)):
            cos, sin = rope2d_freqs(pos, dim)
            self.register_buffer(f"cos_{name}", torch.from_numpy(cos), persistent=False)
            self.register_buffer(f"sin_{name}", torch.from_numpy(sin), persistent=False)

    def head(self, tokens, lin: nn.Linear):
        """(V, N, D) -> pointmaps (V, H, W, 3) and confidences (V, H, W)."""
        c = self.cfg
        h8, w8 = c.img_hw[0] // c.patch, c.img_hw[1] // c.patch
        out = lin(tokens).reshape(-1, h8, w8, c.patch, c.patch, 4)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(-1, h8 * c.patch, w8 * c.patch, 4)
        pts = out[..., :3]
        dd = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
        pts = pts / torch.clamp(dd, min=1e-8) * torch.expm1(dd)
        return pts, 1.0 + torch.exp(torch.clamp(out[..., 3], -10, 10))

    def forward(self, imgs):                 # (V, H, W, 3) in [-1, 1]; view 0 = reference
        c = self.cfg
        V = imgs.shape[0]
        t = self.patch_embed(imgs.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        for i in range(c.enc_depth):
            t = getattr(self, f"enc_{i}")(t, self.cos_enc, self.sin_enc)
        d = self.decoder_embed(layer_norm(self.enc_norm, t))            # (V, N, D)
        cd, sd = self.cos_dec, self.sin_dec
        cos_cat = cd.repeat(V - 1, 1) if V > 1 else cd
        sin_cat = sd.repeat(V - 1, 1) if V > 1 else sd
        cos_k, sin_k = torch.cat([cd, cos_cat]), torch.cat([sd, sin_cat])
        for i in range(c.dec_depth):
            ref, srcs = d[0], d[1:]
            flat = srcs.reshape(-1, c.dec_dim)
            new_ref = getattr(self, f"dec_ref_{i}")(ref, flat if V > 1 else ref, cd, sd,
                                                    cos_cat, sin_cat)
            if V > 1:
                kv = torch.cat([ref, flat])[None].expand(V - 1, -1, -1)
                new_srcs = getattr(self, f"dec_src_{i}")(srcs, kv, cd, sd, cos_k, sin_k)
            else:
                new_srcs = srcs[:0]
            d = torch.cat([new_ref[None], new_srcs])
        d = layer_norm(self.dec_norm, d)
        return (*self.head(d, self.head_global), *self.head(d, self.head_local))


class MVDust3rModel:
    """Multi-view facade on ``device``; ``num_refs > 1`` is the "+"
    multi-reference variant (the most confident reference wins)."""

    def __init__(self, cfg: MVDust3rConfig | None = None, checkpoint: str | None = None,
                 num_refs: int = 1, *, device: torch.device | str = "cuda"):
        self.cfg = cfg or MVDust3rConfig()
        self.num_refs = num_refs
        self.device = torch.device(device)
        self.net = MVDust3rNet(self.cfg)
        self.trained = False
        if checkpoint:
            self.net.load_state_dict(interop.mvdust3r_state_dict(interop.read_npz(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def _prep(self, img) -> np.ndarray:
        return prep_image(img, self.cfg.img_hw, always_8bit=False)

    def run(self, batch: np.ndarray):
        with torch.no_grad():
            return self.net(torch.from_numpy(batch).to(self.device))

    def infer_views(self, images: list) -> dict:
        """-> dict(points (V, H, W, 3) in the reference's frame, conf,
        local_points, local_conf, poses (V, 4, 4) camera-to-reference,
        ref_index), host arrays."""
        V = len(images)
        prepped = [self._prep(im) for im in images]
        best = None
        for r in range(min(self.num_refs, V)):
            order = [r] + [i for i in range(V) if i != r]
            g, gc, loc, lc = (o.cpu().numpy() for o in self.run(
                np.stack([prepped[i] for i in order])))
            mean_conf = float(gc.mean())
            if best is None or mean_conf > best[0]:
                inv = np.argsort(order)
                best = (mean_conf, g[inv], gc[inv], loc[inv], lc[inv], r)
        _, g, gc, loc, lc, ref = best
        poses = []
        for v in range(V):
            a, b = loc[v].reshape(-1, 3), g[v].reshape(-1, 3)
            ok = np.isfinite(a).all(1) & np.isfinite(b).all(1)
            try:
                s, R, t = umeyama_np(a[ok], b[ok], with_scale=True)
                T = np.eye(4)
                T[:3, :3] = s * R
                T[:3, 3] = t
            except Exception:
                T = np.eye(4)
            poses.append(T)
        return {"points": g, "conf": gc, "local_points": loc, "local_conf": lc,
                "poses": np.stack(poses), "ref_index": ref}
