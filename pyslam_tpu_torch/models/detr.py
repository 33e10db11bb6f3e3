"""DETR-class detection transformer with a panoptic mask head (port of
``pyslam_tpu/models/detr.py``).

- A conv backbone to a 1/16 map (four stride-2 "SAME" convolutions, each
  followed by a ReLU'd 3x3 one), plus a 2D sine position encoding.
- A transformer encoder over the memory tokens (``vggt._Block``).
- A decoder of learned object queries (``DecoderBlock``: pre-LN
  self-attention, cross-attention into the memory, an exact-erf GELU MLP).
- Per query: class logits over num_classes + 1 (no-object), a sigmoid
  (cx, cy, w, h) box, and a mask decoded from the last cross-attention
  maps (a 3x3 conv, a 4x bilinear upsample, a 3x3 conv, a 1x1 conv).

The forward runs on the device; ``DetrModel.infer`` scores the queries and
paints the label map on the host, as the reference does.  The modules
carry the JAX package's names; a checkpoint is its ``.npz``
(``interop.detr_state_dict``).  Without one the weights are seeded random
ones (``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import conv_same, layer_norm, resize_hw, truncation_resample
from pyslam_tpu_torch.models.vggt import _Block


@dataclass(frozen=True)
class DetrConfig:
    img_px: int = 256
    dim: int = 128
    heads: int = 8
    enc_depth: int = 3
    dec_depth: int = 3
    num_queries: int = 32
    num_classes: int = 8


def sine_pos_2d(h: int, w: int, dim: int) -> np.ndarray:
    """(h*w, dim) float32 2D sine-cosine position encoding."""
    d4 = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(d4) / d4))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.concatenate([
        np.sin(ys.reshape(-1, 1) * omega), np.cos(ys.reshape(-1, 1) * omega),
        np.sin(xs.reshape(-1, 1) * omega), np.cos(xs.reshape(-1, 1) * omega),
    ], axis=1)
    if out.shape[1] < dim:
        out = np.pad(out, ((0, 0), (0, dim - out.shape[1])))
    return out.astype(np.float32)


def _mha(q, k, v):
    """(Q, h, hd), (N, h, hd) x2 -> ((Q, h * hd), attention (h, Q, N))."""
    hd = q.shape[-1]
    a = torch.softmax(torch.einsum("qhd,khd->hqk", q, k) / np.sqrt(hd), -1)
    return torch.einsum("hqk,khd->qhd", a, v).reshape(q.shape[0], -1), a


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.self_qkv = nn.Linear(dim, 3 * dim)
        self.self_proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.cross_q = nn.Linear(dim, dim)
        self.cross_k = nn.Linear(dim, dim)
        self.cross_v = nn.Linear(dim, dim)
        self.cross_proj = nn.Linear(dim, dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, q, mem):
        """q (Q, D) queries, mem (N, D) -> (q, cross-attention (h, Q, N))."""
        h = self.heads
        qq, kk, vv = self.self_qkv(layer_norm(self.norm1, q)).chunk(3, -1)
        y, _ = _mha(qq.unflatten(-1, (h, -1)), kk.unflatten(-1, (h, -1)),
                    vv.unflatten(-1, (h, -1)))
        q = q + self.self_proj(y)
        y = layer_norm(self.norm2, q)
        y, attn = _mha(self.cross_q(y).unflatten(-1, (h, -1)),
                       self.cross_k(mem).unflatten(-1, (h, -1)),
                       self.cross_v(mem).unflatten(-1, (h, -1)))
        q = q + self.cross_proj(y)
        q = q + self.fc2(F.gelu(self.fc1(layer_norm(self.norm3, q))))
        return q, attn


class DetrNet(nn.Module):
    def __init__(self, cfg: DetrConfig):
        super().__init__()
        self.cfg = c = cfg
        in_ch = 3
        for i, f in enumerate((c.dim // 4, c.dim // 2, c.dim, c.dim)):
            self.add_module(f"backbone{i}", nn.Conv2d(in_ch, f, 3, stride=2))
            self.add_module(f"backbone{i}b", nn.Conv2d(f, f, 3))
            in_ch = f
        self.enc_in = _Block(c.dim, c.heads)
        for i in range(c.enc_depth):
            self.add_module(f"enc_{i}", _Block(c.dim, c.heads))
        self.query_embed = nn.Parameter(torch.zeros(c.num_queries, c.dim))
        for i in range(c.dec_depth):
            self.add_module(f"dec_{i}", DecoderBlock(c.dim, c.heads))
        self.class_head = nn.Linear(c.dim, c.num_classes + 1)
        self.box_head = nn.Linear(c.dim, 4)
        self.mask_conv1 = nn.Conv2d(c.heads, 16, 3)
        self.mask_conv2 = nn.Conv2d(16, 8, 3)
        self.mask_out = nn.Conv2d(8, 1, 1)

    def forward(self, img):
        """(S, S, 3) in [0, 1] -> logits (Q, C + 1), boxes (Q, 4) cxcywh / S,
        masks (Q, S/4, S/4)."""
        c = self.cfg
        x = img.permute(2, 0, 1)[None]
        for i in range(4):
            x = conv_same(getattr(self, f"backbone{i}"), x)
            x = F.relu(conv_same(getattr(self, f"backbone{i}b"), x))
        g = x.shape[-1]
        pos = torch.from_numpy(sine_pos_2d(g, g, c.dim)).to(x.device)
        mem = self.enc_in(x[0].flatten(1).T + pos)
        for i in range(c.enc_depth):
            mem = getattr(self, f"enc_{i}")(mem)
        q, attn = self.query_embed, None
        for i in range(c.dec_depth):
            q, attn = getattr(self, f"dec_{i}")(q, mem)
        logits = self.class_head(q)
        boxes = torch.sigmoid(self.box_head(q))
        amap = attn.transpose(0, 1).reshape(c.num_queries, c.heads, g, g)
        m = F.relu(conv_same(self.mask_conv1, amap))
        m = resize_hw(m, (4 * g, 4 * g))
        m = F.relu(conv_same(self.mask_conv2, m))
        return logits, boxes, self.mask_out(m)[:, 0]


class DetrModel:
    """Detection transformer -> a semantic label map and the instances;
    the network on ``device``."""

    def __init__(self, cfg: DetrConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or DetrConfig()
        self.device = torch.device(device)
        self.net = DetrNet(self.cfg)
        self.trained = False
        if checkpoint:
            self.net.load_state_dict(interop.detr_state_dict(interop.read_npz(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def prepare(self, img) -> np.ndarray:
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        x = truncation_resample(img, (self.cfg.img_px, self.cfg.img_px))
        return np.ascontiguousarray(x / 255.0 if x.max() > 2.0 else x, np.float32)

    def run(self, x: np.ndarray):
        with torch.no_grad():
            return self.net(torch.from_numpy(x).to(self.device))

    def infer(self, img, score_thr: float = 0.5) -> dict:
        """The forward, then on the host: softmax scores, the queries over
        the threshold that are not no-object, painted lowest score first
        (background ``num_classes``), resampled to the image's size."""
        H, W = np.asarray(img).shape[:2]
        S = self.cfg.img_px
        logits, boxes, masks = (o.cpu().numpy() for o in self.run(self.prepare(img)))
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        cls = probs[:, :-1].argmax(-1)
        score = probs[np.arange(len(cls)), cls]
        keep = (score >= score_thr) & (probs.argmax(-1) != self.cfg.num_classes)
        lab_map = np.full((S, S), self.cfg.num_classes, np.int32)
        for qi in np.flatnonzero(keep)[np.argsort(score[keep])]:   # highest painted last
            m = masks[qi]
            m = m.repeat(S // m.shape[0], 0).repeat(S // m.shape[1], 1)
            lab_map[m > 0.0] = cls[qi]
        ys = np.clip((np.arange(H) * S / H).astype(int), 0, S - 1)
        xs = np.clip((np.arange(W) * S / W).astype(int), 0, S - 1)
        boxes_img = boxes * np.array([W, H, W, H])
        return {"labels": lab_map[np.ix_(ys, xs)],
                "instances": {"scores": score[keep], "classes": cls[keep],
                              "boxes_cxcywh": boxes_img[keep], "masks": masks[keep]}}
