"""LoFTR detector-free coarse-to-fine transformer matcher (port of
``pyslam_tpu/models/loftr.py``).

The published architecture (zju3dv/LoFTR ``src/loftr``), with the official
module names, so an official checkpoint loads key for key once its
``matcher.`` prefix is stripped (``torch_convert.loftr_from_torch``):

- ``backbone`` (``ResNetFPN_8_2``): a 7x7/2 grey stem, three stages of two
  BasicBlocks (dims 128, 196, 256 at strides 1, 2, 2), an FPN top-down path
  with 1x1 laterals and (3x3 conv, BN, LeakyReLU, 3x3 conv) fusion: the
  coarse 1/8 map (256 channels) and the fine 1/2 map (128);
- the sine position encoding (``temp_bug_fix`` layout) on the coarse map;
- ``loftr_coarse``: ['self', 'cross'] x 4 encoder layers with linear
  attention (elu + 1 feature maps), bias-free projections, LayerNorm after
  the merge and after the 2d -> 2d -> d MLP on [x ; message]; the same layer
  updates both views in turn, view 2's cross step reading view 1's updated
  features;
- coarse matching: dual softmax at temperature 0.1, mutual argmax, the
  confidence threshold and the top ``max_matches`` (ties to the lower
  index, as ``jax.lax.top_k``);
- fine refinement: 5x5 windows of the fine maps around each coarse match,
  the coarse context (``fine_preprocess.down_proj`` / ``merge_feat``), one
  ['self', 'cross'] fine transformer shared by every match (one batch
  here, ``nn.vmap`` there), and the soft-argmax expectation of view 1's
  centre against view 2's window.

LayerNorm is flax's (fast variance, eps 1e-5), the upsampling of the FPN
the JAX package's bilinear resize (``layers.resize_hw``).  Without a
checkpoint the weights are seeded random ones (``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import (autotuned_convs, layer_norm, resize_hw,
                                            truncation_resample)
from pyslam_tpu_torch.models.resnet import BN
from pyslam_tpu_torch.ops.nms import _topk_stable


# ------------------------------------------------------------- backbone FPN
class _Basic(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BN(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False), BN(planes))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(y + x)


def _fuse(cin: int, cout: int) -> nn.Sequential:
    """(3x3 conv, BN, LeakyReLU, 3x3 conv): ``layer{1,2}_outconv2``."""
    return nn.Sequential(nn.Conv2d(cin, cin, 3, padding=1, bias=False), BN(cin),
                         nn.LeakyReLU(0.01), nn.Conv2d(cin, cout, 3, padding=1, bias=False))


class ResNetFPN_8_2(nn.Module):
    def __init__(self, dims: tuple = (128, 196, 256)):
        super().__init__()
        d1, d2, d3 = dims
        self.conv1 = nn.Conv2d(1, d1, 7, stride=2, padding=3, bias=False)
        self.bn1 = BN(d1)
        self.layer1 = nn.Sequential(_Basic(d1, d1), _Basic(d1, d1))
        self.layer2 = nn.Sequential(_Basic(d1, d2, 2), _Basic(d2, d2))
        self.layer3 = nn.Sequential(_Basic(d2, d3, 2), _Basic(d3, d3))
        self.layer3_outconv = nn.Conv2d(d3, d3, 1, bias=False)
        self.layer2_outconv = nn.Conv2d(d2, d3, 1, bias=False)
        self.layer2_outconv2 = _fuse(d3, d2)
        self.layer1_outconv = nn.Conv2d(d1, d2, 1, bias=False)
        self.layer1_outconv2 = _fuse(d2, d1)

    def forward(self, x):            # (B, 1, H, W) -> coarse (B, d3, H/8, W/8), fine (B, d1, H/2, W/2)
        x0 = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x3_out = self.layer3_outconv(x3)
        x2_lat = self.layer2_outconv(x2)
        x2_out = self.layer2_outconv2(x2_lat + resize_hw(x3_out, x2_lat.shape[-2:]))
        x1_lat = self.layer1_outconv(x1)
        x1_out = self.layer1_outconv2(x1_lat + resize_hw(x2_out, x1_lat.shape[-2:]))
        return x3_out, x1_out


# -------------------------------------------------------- positional encode
def sine_pos_encoding(h: int, w: int, d_model: int = 256) -> np.ndarray:
    """LoFTR PositionEncodingSine (temp_bug_fix=True layout), (h, w, d)."""
    pe = np.zeros((h, w, d_model), np.float32)
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                 * (-np.log(10000.0) / (d_model // 2)))
    pe[..., 0::4] = np.sin(x[..., None] * div)
    pe[..., 1::4] = np.cos(x[..., None] * div)
    pe[..., 2::4] = np.sin(y[..., None] * div)
    pe[..., 3::4] = np.cos(y[..., None] * div)
    return pe


# ------------------------------------------------------- linear transformer
def _linear_attention(q, k, v, eps: float = 1e-6):
    """(..., L, H, D) linear attention with elu + 1 feature maps over a
    source of (..., S, H, D)."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    S = v.shape[-3]
    v = v / S
    KV = torch.einsum("...shd,...shv->...hdv", K, v)
    Z = 1.0 / (torch.einsum("...lhd,...hd->...lh", Q, K.sum(-3)) + eps)
    return torch.einsum("...lhd,...hdv->...lhv", Q, KV) * Z[..., None] * S


class LoFTREncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.merge = nn.Linear(dim, dim, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * dim, 2 * dim, bias=False), nn.ReLU(),
                                 nn.Linear(2 * dim, dim, bias=False))
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, source):    # (..., L, d), (..., S, d)
        hd = self.dim // self.heads
        q = self.q_proj(x).unflatten(-1, (self.heads, hd))
        k = self.k_proj(source).unflatten(-1, (self.heads, hd))
        v = self.v_proj(source).unflatten(-1, (self.heads, hd))
        m = self.merge(_linear_attention(q, k, v).flatten(-2))
        m = layer_norm(self.norm1, m)
        m = self.mlp(torch.cat([x, m], -1))
        return x + layer_norm(self.norm2, m)


class LocalFeatureTransformer(nn.Module):
    """``layers`` = [self_0, cross_0, self_1, cross_1, ...]."""

    def __init__(self, dim: int, heads: int, n_pairs: int):
        super().__init__()
        self.layers = nn.ModuleList(LoFTREncoderLayer(dim, heads) for _ in range(2 * n_pairs))

    def forward(self, f1, f2):
        for i in range(0, len(self.layers), 2):
            s, c = self.layers[i], self.layers[i + 1]
            f1 = s(f1, f1)
            f2 = s(f2, f2)
            f1 = c(f1, f2)
            f2 = c(f2, f1)
        return f1, f2


class _FinePreprocess(nn.Module):
    def __init__(self, d_c: int, d_f: int):
        super().__init__()
        self.down_proj = nn.Linear(d_c, d_f)
        self.merge_feat = nn.Linear(2 * d_f, d_f)


# --------------------------------------------------------------- full model
@dataclass
class LoFTRConfig:
    img_hw: tuple = (480, 640)
    dims: tuple = (128, 196, 256)
    coarse_layers: int = 4
    fine_layers: int = 1
    heads: int = 8
    temperature: float = 0.1
    conf_threshold: float = 0.2
    fine_window: int = 5
    max_matches: int = 1024


class LoFTRNet(nn.Module):
    def __init__(self, cfg: LoFTRConfig):
        super().__init__()
        self.cfg = cfg
        d_c, d_f = cfg.dims[2], cfg.dims[0]
        self.backbone = ResNetFPN_8_2(cfg.dims)
        self.loftr_coarse = LocalFeatureTransformer(d_c, cfg.heads, cfg.coarse_layers)
        self.fine_preprocess = _FinePreprocess(d_c, d_f)
        self.loftr_fine = LocalFeatureTransformer(d_f, cfg.heads, cfg.fine_layers)
        H, W = cfg.img_hw
        self.register_buffer("pe", torch.from_numpy(sine_pos_encoding(H // 8, W // 8, d_c)),
                             persistent=False)

    def coarse(self, img1, img2):
        """(H, W) images -> the coarse features after the transformer (N, d)
        of both views and the fine maps (H/2, W/2, d_f)."""
        d_c = self.cfg.dims[2]
        x = torch.stack([img1, img2])[:, None]
        # cuDNN's default choice for these float32 convolutions (TF32 off) is
        # an FFT algorithm of ~130k complex GEMM launches (1.1-1.3 s a pair on
        # the card, PERF.md); autotuning picks a direct one for each shape
        with autotuned_convs():
            c, fine = self.backbone(x)
        f = (c.permute(0, 2, 3, 1) + self.pe).reshape(2, -1, d_c)
        f1, f2 = self.loftr_coarse(f[0], f[1])
        return f1, f2, fine.permute(0, 2, 3, 1)

    def match_coarse(self, f1, f2):
        """Dual-softmax matching: (P's row argmax nn12, conf_all, the top
        scores and their rows top_i1)."""
        c = self.cfg
        hc, wc = c.img_hw[0] // 8, c.img_hw[1] // 8
        f1n = f1 / torch.clamp(torch.linalg.vector_norm(f1, dim=1, keepdim=True), min=1e-6)
        f2n = f2 / torch.clamp(torch.linalg.vector_norm(f2, dim=1, keepdim=True), min=1e-6)
        S = (f1n @ f2n.T) / c.temperature
        P = torch.softmax(S, 0) * torch.softmax(S, 1)
        nn12 = torch.argmax(P, 1)
        nn21 = torch.argmax(P, 0)
        conf_all = torch.amax(P, 1)
        mutual = nn21[nn12] == torch.arange(P.shape[0], device=P.device)
        ok = mutual & (conf_all > c.conf_threshold)
        score = torch.where(ok, conf_all, torch.full_like(conf_all, -1.0))
        top_conf, top_i1 = _topk_stable(score, min(c.max_matches, hc * wc))
        return nn12, conf_all, top_conf, top_i1

    def forward(self, img1, img2):
        """img: (H, W) grey in [0, 1].  Returns (xy1 (M, 2), xy2 (M, 2),
        conf (M,), valid (M,)) at full resolution."""
        c = self.cfg
        wc = c.img_hw[1] // 8
        d_f = c.dims[0]
        f1, f2, fine = self.coarse(img1, img2)
        nn12, _, top_conf, top_i1 = self.match_coarse(f1, f2)
        top_i2 = nn12[top_i1]
        valid = top_conf > 0

        # fine refinement: 5x5 windows on the 1/2-resolution maps
        Wf = c.fine_window
        s = 4                        # coarse cell = 8 px, fine px = 2 px
        fy1, fx1 = (top_i1 // wc) * s + s // 2, (top_i1 % wc) * s + s // 2
        fy2, fx2 = (top_i2 // wc) * s + s // 2, (top_i2 % wc) * s + s // 2
        off = torch.arange(Wf, device=img1.device) - Wf // 2

        def windows(fmap, ys, xs):   # (M, Wf * Wf, d_f)
            yy = torch.clamp(ys[:, None, None] + off[None, :, None], 0, fmap.shape[0] - 1)
            xx = torch.clamp(xs[:, None, None] + off[None, None, :], 0, fmap.shape[1] - 1)
            return fmap[yy, xx].reshape(-1, Wf * Wf, d_f)

        w1, w2 = windows(fine[0], fy1, fx1), windows(fine[1], fy2, fx2)
        pre = self.fine_preprocess
        c1, c2 = pre.down_proj(f1[top_i1]), pre.down_proj(f2[top_i2])
        w1 = pre.merge_feat(torch.cat([w1, c1[:, None].expand_as(w1)], -1))
        w2 = pre.merge_feat(torch.cat([w2, c2[:, None].expand_as(w2)], -1))
        w1, w2 = self.loftr_fine(w1, w2)

        # expectation over the correlation heatmap (FineMatching)
        center = w1[:, (Wf * Wf) // 2]
        heat = torch.softmax(torch.einsum("md,mwd->mw", center, w2) / (d_f ** 0.5), -1)
        gy, gx = torch.meshgrid(off, off, indexing="ij")
        grid = torch.stack([gx, gy], -1).reshape(-1, 2).to(torch.float32)
        delta = heat @ grid
        xy1 = torch.stack([fx1, fy1], 1).to(torch.float32) * 2.0
        xy2 = (torch.stack([fx2, fy2], 1).to(torch.float32) + delta) * 2.0
        return xy1, xy2, top_conf, valid


class LoFTRMatcher:
    """Image-pair matcher on ``device``: one forward a pair.  Without
    ``checkpoint`` seeded random weights (``trained = False``); an
    official ``.ckpt`` / ``.pth`` is read by ``loftr_from_torch``."""

    def __init__(self, cfg: LoFTRConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or LoFTRConfig()
        self.device = torch.device(device)
        self.net = LoFTRNet(self.cfg)
        self.trained = False
        if checkpoint:
            from pyslam_tpu_torch.models.torch_convert import load_torch_file, loftr_from_torch

            self.net.load_state_dict(loftr_from_torch(load_torch_file(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def prep(self, img) -> torch.Tensor:
        """Grey / colour, 8-bit or [0, 1] image -> (H, W) float32 on the
        device at ``img_hw``, resampled by integer truncation (the
        reference's host code, copied)."""
        img = np.asarray(img, np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        if img.max() > 2.0:
            img = img / 255.0
        img = truncation_resample(img, self.cfg.img_hw)
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    def run(self, img1, img2):
        """The network on two images -> device (xy1, xy2, conf, valid)."""
        with torch.no_grad():
            return self.net(self.prep(img1), self.prep(img2))

    def match_pair(self, img1, img2):
        """uint8 / float grey images -> (xy1, xy2, conf) host arrays in input
        pixels.  Both point sets are scaled by image 1's size, as the
        reference scales them."""
        h1, w1 = np.asarray(img1).shape[:2]
        H, W = self.cfg.img_hw
        xy1, xy2, conf, valid = (t.cpu().numpy() for t in self.run(img1, img2))
        sx, sy = w1 / W, h1 / H
        xy1 = xy1[valid] * [sx, sy]
        xy2 = xy2[valid] * [sx, sy]
        return xy1.astype(np.float32), xy2.astype(np.float32), conf[valid]
