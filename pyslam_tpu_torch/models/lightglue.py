"""LightGlue-class attention matcher (port of
``pyslam_tpu/models/lightglue.py``).

The published LightGlue design: descriptors projected to ``dim``, layers of
self attention (2-D rotary positional encoding, interleaved pairs) and
cross attention with shared weights, each followed by an FFN with
LayerNorm (eps 1e-6, flax's) and exact GELU; then a dual-softmax partial
assignment with a matchability head.  Masked entries take -1e9, as in the
reference, so a fully masked row stays finite (no
``scaled_dot_product_attention``, whose boolean mask gives -inf).  The
modules carry the flax names (``input_proj``, ``layer_{i}.self_attn.to_q``,
``layer_{i}.self_ffn0_ln`` ...), which is also the layout of a LightGlue
torch checkpoint for the JAX package's ``generic_from_torch``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop

_BIG_NEG = -1e9


def apply_rotary(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate the feature pairs (x[..., 0::2], x[..., 1::2]) of (H, N, D)
    by per-position angles theta (N, D/2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        # the reference's 1 / sqrt(head dim), a float32 constant
        self.scale = float(np.float32(1.0) / np.sqrt(np.float32(dim // heads)))

    def forward(self, x, source, theta_x=None, theta_s=None, mask=None):
        """x (N, D) attends to source (M, D) -> (N, D) message."""
        hd = self.dim // self.heads

        def split(t):
            return t.reshape(-1, self.heads, hd).transpose(0, 1)

        q, k, v = split(self.to_q(x)), split(self.to_k(source)), split(self.to_v(source))
        if theta_x is not None:
            q = apply_rotary(q, theta_x)
            k = apply_rotary(k, theta_s)
        att = (q @ k.transpose(1, 2)) * self.scale
        if mask is not None:
            att = torch.where(mask[None, None, :], att, torch.full_like(att, _BIG_NEG))
        att = torch.softmax(att, dim=-1)
        msg = (att @ v).transpose(0, 1).reshape(-1, self.dim)
        return self.to_out(msg)


class GlueLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.self_attn = Attention(dim, heads)
        self.cross_attn = Attention(dim, heads)
        for name in ("self_ffn0", "self_ffn1", "cross_ffn0", "cross_ffn1"):
            self.add_module(f"{name}_fc1", nn.Linear(2 * dim, 2 * dim))
            self.add_module(f"{name}_ln", nn.LayerNorm(2 * dim, eps=1e-6))
            self.add_module(f"{name}_fc2", nn.Linear(2 * dim, dim))

    def _ffn(self, name, x, msg):
        h = getattr(self, f"{name}_fc1")(torch.cat([x, msg], dim=-1))
        h = F.gelu(getattr(self, f"{name}_ln")(h), approximate="none")
        return x + getattr(self, f"{name}_fc2")(h)

    def forward(self, x0, x1, th0, th1, m0, m1):
        msg0 = self.self_attn(x0, x0, th0, th0, m0)
        msg1 = self.self_attn(x1, x1, th1, th1, m1)
        x0 = self._ffn("self_ffn0", x0, msg0)
        x1 = self._ffn("self_ffn1", x1, msg1)
        # cross attention: no positions across images
        msg0 = self.cross_attn(x0, x1, None, None, m1)
        msg1 = self.cross_attn(x1, x0, None, None, m0)
        x0 = self._ffn("cross_ffn0", x0, msg0)
        x1 = self._ffn("cross_ffn1", x1, msg1)
        return x0, x1


class LightGlueNet(nn.Module):
    def __init__(self, dim: int = 256, layers: int = 9, heads: int = 4, input_dim: int = 256):
        super().__init__()
        self.dim, self.layers, self.heads, self.input_dim = dim, layers, heads, input_dim
        self.input_proj = nn.Linear(input_dim, dim)          # shared by both images
        self.rotary_w = nn.Parameter(torch.zeros(2, dim // heads // 2))
        for i in range(layers):
            self.add_module(f"layer_{i}", GlueLayer(dim, heads))
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)
        self.sim_scale = float(np.float32(1.0) / np.float32(dim ** 0.25))

    def forward(self, desc0, xy0, m0, desc1, xy1, m1, return_aux: bool = False):
        """(N, input_dim), (N, 2) normalised coordinates, (N,) mask, and
        the same for the other image -> (log-assignment scores (N, M), the
        masked similarity); with ``return_aux`` also the per-keypoint
        matchability logits ``sig0`` (N,) and ``sig1`` (M,) (the training
        loss needs them, LightGlue eq. 10)."""
        x0, x1 = self.input_proj(desc0), self.input_proj(desc1)
        th0, th1 = xy0 @ self.rotary_w, xy1 @ self.rotary_w
        for i in range(self.layers):
            x0, x1 = getattr(self, f"layer_{i}")(x0, x1, th0, th1, m0, m1)
        f0, f1 = self.final_proj(x0), self.final_proj(x1)
        sim = (f0 @ f1.T) * self.sim_scale
        sig0 = self.matchability(x0)[:, 0]
        sig1 = self.matchability(x1)[:, 0]
        # dual-softmax partial assignment with matchability (LightGlue eq. 8)
        sim = torch.where(m0[:, None] & m1[None, :], sim, torch.full_like(sim, _BIG_NEG))
        z0 = torch.log_softmax(sim, dim=1)
        z1 = torch.log_softmax(sim, dim=0)
        scores = F.logsigmoid(sig0)[:, None] + F.logsigmoid(sig1)[None, :] + z0 + z1
        if return_aux:
            return scores, sim, sig0, sig1
        return scores, sim


class LightGlueMatcher:
    """(FeatureData, FeatureData) -> match indices on ``device``.

    Without ``checkpoint`` it adopts the bundled ``lightglue_tiny.npz``
    and its ``__dim__`` / ``__layers__`` when its ``__input_dim__`` is
    ``input_dim``; ``checkpoint`` may name a JAX-package ``.npz`` or a
    torch ``.pth`` of the same architecture.  Random weights (``trained =
    False``) otherwise."""

    def __init__(self, dim: int = 256, layers: int = 9, input_dim: int = 256,
                 threshold: float = 0.1, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.threshold = threshold
        self.trained = False
        if checkpoint is None:
            default = interop.bundled_checkpoint("lightglue_tiny")
            if default is not None:
                flat = interop.read_npz(default)
                if int(flat["__input_dim__"]) == input_dim:
                    dim, layers = int(flat["__dim__"]), int(flat["__layers__"])
                    checkpoint = default
        self.net = LightGlueNet(dim=dim, layers=layers, input_dim=input_dim)
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        if str(path).endswith((".pth", ".pt")):
            from pyslam_tpu_torch.models.torch_convert import load_torch_file

            state = load_torch_file(path)
        else:
            state = interop.lightglue_state_dict(interop.read_npz(path))
        self.net.load_state_dict(state)
        self.trained = True

    def scores(self, f0, f1, image_wh=(640.0, 480.0)) -> torch.Tensor:
        """The log-assignment scores (N, M) of two FeatureData, the
        coordinates normalised by the image's half size."""
        dev = self.device
        c = torch.tensor(image_wh, dtype=torch.float32, device=dev) / 2.0
        cmax = torch.max(c)

        def norm(xy):
            return (xy.to(dev, torch.float32) - c) / cmax

        with torch.no_grad():
            s, _ = self.net(f0.desc.to(dev, torch.float32), norm(f0.xy), f0.valid.to(dev),
                            f1.desc.to(dev, torch.float32), norm(f1.xy), f1.valid.to(dev))
        return s

    def match(self, f0, f1, image_wh=(640.0, 480.0)):
        """(idx (N,) int64 into f1, -1 where unmatched; confidence (N,)) on
        the device: mutual best of exp(scores), above ``threshold``."""
        p = torch.exp(self.scores(f0, f1, image_wh))
        best1 = torch.argmax(p, dim=1)
        best0 = torch.argmax(p, dim=0)
        mutual = best0[best1] == torch.arange(p.shape[0], device=p.device)
        conf = torch.max(p, dim=1).values
        keep = mutual & (conf > self.threshold) & f0.valid.to(p.device)
        return torch.where(keep, best1, torch.full_like(best1, -1)), conf
