"""ALIKED detector / descriptor, aliked-n16 (port of
``pyslam_tpu/models/aliked.py``).

A backbone of four blocks at 1, 1/2, 1/8 and 1/32 resolution (``block1`` a
ConvBlock, ``block2..block4`` ResBlocks, 3 and 4 with deformable 3x3
convolutions), SELU gates and batch norm; 1x1 projections to dim/4
channels, bilinear upsampling to full resolution and concatenation; the
SMH score head (1x1 -> 8, 3x3 -> 4, 3x3 -> 4, 3x3 -> 1, sigmoid); DKD
keypoints (grid top-k, then a 5x5 soft-argmax at temperature 0.1) and the
SDDH descriptor head (a 3x3 patch predicts 16 sample offsets; the samples
are mixed by ``sf_conv`` and aggregated by per-sample matrices).

The modules keep the official ALIKED names (``block{1-4}``,
``conv{1-4}``, ``score_head.{0,2,4,6}``, ``desc_head.offset_conv.{0,2}``,
``desc_head.sf_conv``, ``desc_head.agg_weights``), so the official
checkpoint loads after ``torch_convert.aliked_from_torch`` drops the batch
counters.  Every bilinear sample goes through ``bilinear_sample``, the
reference's own boundary rule: floor the coordinates, clamp both indices to
the map, keep the weights of the unclamped floor (neither of
``grid_sample``'s paddings).  A deformable convolution is its k*k such
gathers followed by one matrix product.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import (
    feature_data,
    l2_normalize,
    resize_hw,
    rgb_image,
    selu,
    single_level,
)
from pyslam_tpu_torch.models.resnet import BN
from pyslam_tpu_torch.models.superpoint import _INV_255
from pyslam_tpu_torch.ops import nms as nms_ops

_INV_TEMP = 10.0   # XLA's float32 reciprocal of the DKD temperature 0.1


@dataclass(frozen=True)
class AlikedConfig:
    # aliked-n16 sizing
    c1: int = 16
    c2: int = 32
    c3: int = 64
    c4: int = 128
    dim: int = 128
    K: int = 3      # SDDH patch kernel
    M: int = 16     # SDDH deformable sample positions


def bilinear_sample(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample a (H, W, C) map at float (y, x) positions of any shape ->
    (..., C): indices clamped to the map, weights of the floor kept."""
    h, w = x.shape[:2]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ay = (ys - y0)[..., None]
    ax = (xs - x0)[..., None]
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    flat = x.reshape(h * w, -1)

    def tap(yi, xi):
        return flat[(yi * w + xi).reshape(-1)].reshape(*yi.shape, flat.shape[1])

    v00, v01, v10, v11 = tap(y0i, x0i), tap(y0i, x1i), tap(y1i, x0i), tap(y1i, x1i)
    return (v00 * (1 - ax) + v01 * ax) * (1 - ay) + (v10 * (1 - ax) + v11 * ax) * ay


class DeformConv(nn.Module):
    """3x3 deformable convolution: a regular conv predicts (dy, dx) for
    each tap, the taps are sampled and contracted with ``conv``'s kernel."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.k = k
        self.offset_conv = nn.Conv2d(cin, 2 * k * k, k, padding=(k - 1) // 2)
        self.conv = nn.Conv2d(cin, cout, k)        # its weights only

    def forward(self, x):                            # (1, C, H, W)
        k = self.k
        _, c, h, w = x.shape
        off = self.offset_conv(x)[0].permute(1, 2, 0)   # (H, W, 2kk): (dy, dx) a tap
        hwc = x[0].permute(1, 2, 0)
        ys = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
        xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
        r = (k - 1) // 2
        taps, t = [], 0
        for di in range(-r, r + 1):
            for dj in range(-r, r + 1):
                taps.append(bilinear_sample(hwc, ys + di + off[..., 2 * t],
                                            xs + dj + off[..., 2 * t + 1]))
                t += 1
        stacked = torch.cat(taps, -1)                     # (H, W, k*k*C)
        dense = self.conv.weight.permute(2, 3, 1, 0).reshape(k * k * c, -1)
        y = stacked @ dense + self.conv.bias
        return y.permute(2, 0, 1)[None]


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn1 = BN(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BN(cout)

    def forward(self, x):
        x = selu(self.bn1(self.conv1(x)))
        return selu(self.bn2(self.conv2(x)))


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, deformable: bool = False):
        super().__init__()
        if deformable:
            self.conv1, self.conv2 = DeformConv(cin, cout), DeformConv(cout, cout)
        else:
            self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
            self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn1 = BN(cout)
        self.bn2 = BN(cout)
        self.downsample = nn.Conv2d(cin, cout, 1, bias=False) if cin != cout else None

    def forward(self, x):
        y = selu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return selu(x + y)


class SDDH(nn.Module):
    """Sparse deformable descriptor head over a set of keypoints."""

    def __init__(self, cfg: AlikedConfig = AlikedConfig()):
        super().__init__()
        self.cfg = cfg
        k, m, dim = cfg.K, cfg.M, cfg.dim
        self.offset_conv = nn.Sequential(nn.Conv2d(dim, 2 * m, k), nn.SELU(),
                                         nn.Conv2d(2 * m, 2 * m, 1))
        self.sf_conv = nn.Conv2d(dim, dim, 1, bias=False)
        self.agg_weights = nn.Parameter(torch.zeros(m, dim, dim))

    def forward(self, feats, xy):           # feats (H, W, dim), xy (N, 2) [x, y]
        k, m, dim = self.cfg.K, self.cfg.M, self.cfg.dim
        r = (k - 1) // 2
        d = torch.arange(-r, r + 1, dtype=torch.float32, device=feats.device)
        dyy, dxx = torch.meshgrid(d, d, indexing="ij")
        py = xy[:, 1, None] + dyy.reshape(-1)[None, :]          # (N, K*K)
        px = xy[:, 0, None] + dxx.reshape(-1)[None, :]
        patch = bilinear_sample(feats, py, px)                   # (N, K*K, dim)
        # the KxK conv over the patch is one product over the flattened taps
        w0 = self.offset_conv[0].weight.permute(0, 2, 3, 1).reshape(2 * m, k * k * dim)
        h = selu(patch.reshape(patch.shape[0], -1) @ w0.T + self.offset_conv[0].bias)
        w2 = self.offset_conv[2].weight.reshape(2 * m, 2 * m)
        off = (h @ w2.T + self.offset_conv[2].bias).reshape(-1, m, 2)   # (dy, dx)
        samp = bilinear_sample(feats, xy[:, 1, None] + off[..., 0],
                               xy[:, 0, None] + off[..., 1])            # (N, M, dim)
        samp = selu(samp @ self.sf_conv.weight.reshape(dim, dim).T)
        desc = torch.einsum("nmc,mcd->nd", samp, self.agg_weights)
        return l2_normalize(desc)


class AlikedNet(nn.Module):
    """Backbone + SMH + ``desc_head`` (SDDH)."""

    def __init__(self, cfg: AlikedConfig = AlikedConfig()):
        super().__init__()
        c = cfg
        self.block1 = ConvBlock(3, c.c1)
        self.block2 = ResBlock(c.c1, c.c2)
        self.block3 = ResBlock(c.c2, c.c3, deformable=True)
        self.block4 = ResBlock(c.c3, c.c4, deformable=True)
        d = c.dim // 4
        for i, ch in enumerate((c.c1, c.c2, c.c3, c.c4)):
            self.add_module(f"conv{i + 1}", nn.Conv2d(ch, d, 1))
        self.score_head = nn.Sequential(
            nn.Conv2d(c.dim, 8, 1), nn.SELU(), nn.Conv2d(8, 4, 3, padding=1), nn.SELU(),
            nn.Conv2d(4, 4, 3, padding=1), nn.SELU(), nn.Conv2d(4, 1, 3, padding=1))
        self.desc_head = SDDH(cfg)

    def forward(self, img):
        """(1, 3, H, W) in [0, 1], H and W multiples of 32 -> the feature
        map (H, W, dim) and the score map (H, W)."""
        h, w = img.shape[-2:]
        pool = torch.nn.functional.avg_pool2d
        x1 = self.block1(img)
        x2 = self.block2(pool(x1, 2))
        x3 = self.block3(pool(x2, 4))
        x4 = self.block4(pool(x3, 4))
        feats = torch.cat([resize_hw(getattr(self, f"conv{i + 1}")(x), (h, w))
                           for i, x in enumerate((x1, x2, x3, x4))], 1)
        s = self.score_head
        y = selu(s[0](feats))
        y = selu(s[2](y))
        y = selu(s[4](y))
        score = torch.sigmoid(s[6](y)[0, 0])
        return feats[0].permute(1, 2, 0), score


def subpixel_refine(score: torch.Tensor, xy: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """DKD sub-pixel: soft-argmax of the (2r+1)^2 score patch."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=score.device)
    dyy, dxx = torch.meshgrid(d, d, indexing="ij")
    dyy, dxx = dyy.reshape(-1), dxx.reshape(-1)
    patch = bilinear_sample(score[..., None], xy[:, 1, None] + dyy[None, :],
                            xy[:, 0, None] + dxx[None, :])[..., 0]      # (N, P)
    w = torch.softmax(patch * _INV_TEMP, dim=-1)
    return xy + torch.stack([(w * dxx).sum(-1), (w * dyy).sum(-1)], -1)


class AlikedExtractor:
    """(H, W) grey or (H, W, 3) image -> FeatureData on ``device``
    (``num_features`` slots, size 8, 128-d unit descriptors, L2).

    ``checkpoint``: the official ALIKED ``.pth``; without one seeded random
    weights (``trained = False``)."""

    def __init__(self, num_features: int = 2000, checkpoint: str | None = None,
                 nms_cell: int = 8, cfg: AlikedConfig | None = None, *,
                 device: torch.device | str = "cuda"):
        single_level(self, num_features, device)
        self.nms_cell = nms_cell
        self.cfg = cfg or AlikedConfig()
        self.net = AlikedNet(self.cfg)
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        from pyslam_tpu_torch.models import torch_convert

        self.net.load_state_dict(
            torch_convert.aliked_from_torch(torch_convert.load_torch_file(path)))
        self.trained = True

    def maps(self, img: torch.Tensor) -> dict[str, torch.Tensor]:
        """(H, W, 3) float32 image on the device -> feature map (H', W',
        dim) and score map (H', W') of the crop to multiples of 32."""
        h, w = img.shape[:2]
        x = img[: h // 32 * 32, : w // 32 * 32].permute(2, 0, 1)[None] * _INV_255
        with torch.no_grad():
            feats, score = self.net(x)
        return {"feats": feats, "score": score}

    def extract(self, img: torch.Tensor):
        m = self.maps(img)
        feats, score = m["feats"], m["score"]
        hc, wc = score.shape
        xy, resp, valid = nms_ops.grid_topk_keypoints(score[None], cell=self.nms_cell,
                                                      per_cell=4, max_out=self.num_features)
        xy, resp, valid = xy[0], resp[0], valid[0]
        xy = subpixel_refine(score, xy)
        hi = torch.tensor([wc - 1.0, hc - 1.0], dtype=torch.float32, device=xy.device)
        xy = torch.minimum(torch.clamp(xy, min=0.0), hi)
        with torch.no_grad():
            desc = self.net.desc_head(feats, xy)
        return feature_data(xy, resp, valid, desc)

    def __call__(self, img):
        return self.extract(rgb_image(img, self.device))
