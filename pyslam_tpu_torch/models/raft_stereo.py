"""RAFT-class recurrent stereo (port of ``pyslam_tpu/models/raft_stereo.py``).

A feature encoder at 1/4 resolution (a 7x7 stride-2 stem and residual
blocks with flax ``GroupNorm``), an all-pairs 1D correlation volume along
each row with a pyramid of pooled levels, iterative ConvGRU updates that
look the volume up around the current disparity, and a convex upsampling
(a softmax over each pixel's 3x3 coarse neighbours) back to full
resolution.  The iterations are a Python loop (the JAX package's is
unrolled in one XLA graph).

``lookup`` copies the reference's border rule: the left tap index is
clipped first and the interpolation fraction taken from the clipped index,
so off the edges the weights extrapolate.  The pyramid pools pairs of
columns; a level of odd width drops its last column, as the official
RAFT-Stereo's ``avg_pool2d`` does, where the reference cannot reshape it
and raises (widths whose quarter is not divisible by 2 ** (levels - 1),
e.g. KITTI's 1232 crop at 4 levels).  Constant divisors are multiplies by
their float32 reciprocals, as XLA computes them.  The modules carry the
JAX package's names.  Without a checkpoint (the JAX package's ``.npz``)
the weights are seeded random ones (``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import GroupNormF, autotuned_convs


@dataclass
class RaftStereoConfig:
    feat_dim: int = 96
    hidden_dim: int = 64
    context_dim: int = 64
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    max_disp: float = 192.0


class ResBlock(nn.Module):
    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, ch, 3, stride=stride, padding=1)
        self.gn1 = GroupNormF(8, ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)
        self.gn2 = GroupNormF(8, ch)
        if stride != 1 or cin != ch:
            self.down = nn.Conv2d(cin, ch, 1, stride=stride)

    def forward(self, x):
        y = F.relu(self.gn1(self.conv1(x)))
        y = self.gn2(self.conv2(y))
        if hasattr(self, "down"):
            x = self.down(x)
        return F.relu(x + y)


class Encoder(nn.Module):
    """(B, 1, H, W) -> (B, out, H/4, W/4)."""

    def __init__(self, out_dim: int):
        super().__init__()
        self.stem = nn.Conv2d(1, 32, 7, stride=2, padding=3)
        self.res1 = ResBlock(32, 32)
        self.res2 = ResBlock(32, 48, stride=2)
        self.res3 = ResBlock(48, 64)
        self.out = nn.Conv2d(64, out_dim, 1)

    def forward(self, x):
        x = self.res3(self.res2(self.res1(F.relu(self.stem(x)))))
        return self.out(x)


def corr_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int):
    """f1, f2: (H, W, D) quarter-resolution features -> ``levels`` volumes
    (H, W, W / 2 ** l), each the mean of the previous level's column
    pairs."""
    d = f1.shape[-1]
    inv = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    pyr = [torch.einsum("hwd,hvd->hwv", f1, f2) * inv]
    for _ in range(levels - 1):
        h, w, v = pyr[-1].shape
        pyr.append(pyr[-1][..., : 2 * (v // 2)].reshape(h, w, v // 2, 2).mean(-1))
    return pyr


def lookup(pyr, disp: torch.Tensor, radius: int) -> torch.Tensor:
    """Each level sampled at (x - disp) / 2 ** l + r, r in [-radius,
    radius], linear along the row with the reference's border rule.
    disp: (H, W) -> (H, W, levels * (2 radius + 1))."""
    h, w = disp.shape
    xs = torch.arange(w, dtype=torch.float32, device=disp.device)[None, :]
    out = []
    for lvl, c in enumerate(pyr):
        center = (xs - disp) * float(np.float32(1.0) / np.float32(2.0 ** lvl))
        n = c.shape[2]
        for r in range(-radius, radius + 1):
            pos = center + r
            x0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
            x1 = torch.clamp(x0 + 1, 0, n - 1)
            f = pos - x0.to(torch.float32)
            v0 = torch.gather(c, 2, x0[..., None])[..., 0]
            v1 = torch.gather(c, 2, x1[..., None])[..., 0]
            out.append(v0 * (1 - f) + v1 * f)
    return torch.stack(out, -1)


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        self.convz = nn.Conv2d(hidden + cin, hidden, 3, padding=1)
        self.convr = nn.Conv2d(hidden + cin, hidden, 3, padding=1)
        self.convq = nn.Conv2d(hidden + cin, hidden, 3, padding=1)

    def forward(self, h, x):                 # (B, C, H, W)
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


class UpdateBlock(nn.Module):
    def __init__(self, cfg: RaftStereoConfig):
        super().__init__()
        c = cfg
        n_corr = c.corr_levels * (2 * c.corr_radius + 1)
        self.convc1 = nn.Conv2d(n_corr, 64, 1)
        self.convc2 = nn.Conv2d(64, 48, 3, padding=1)
        self.convf1 = nn.Conv2d(1, 48, 7, padding=3)
        self.convf2 = nn.Conv2d(48, 32, 3, padding=1)
        self.gru = ConvGRU(c.hidden_dim, 48 + 32 + 1 + c.context_dim)
        self.head1 = nn.Conv2d(c.hidden_dim, 64, 3, padding=1)
        self.head2 = nn.Conv2d(64, 1, 3, padding=1)
        self.mask = nn.Conv2d(c.hidden_dim, 16 * 9, 1)

    def forward(self, h, context, corr_feat, disp):
        """h, context (1, C, H, W); corr_feat (H, W, K); disp (H, W)."""
        d = disp[None, None]
        m = F.relu(self.convc1(corr_feat.permute(2, 0, 1)[None]))
        m = F.relu(self.convc2(m))
        f = F.relu(self.convf2(F.relu(self.convf1(d))))
        h = self.gru(h, torch.cat([m, f, d, context], 1))
        dd = self.head2(F.relu(self.head1(h)))[0, 0]
        return h, dd, self.mask(h)[0].permute(1, 2, 0)


def convex_upsample(disp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """disp (H, W) at 1/4 resolution and mask (H, W, 144) -> (4H, 4W)
    disparity in full-resolution pixels."""
    h, w = disp.shape
    m = torch.softmax(mask.reshape(h, w, 16, 9), -1)
    pad = F.pad(disp[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    neigh = torch.stack([pad[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], -1)
    up = torch.einsum("hwks,hws->hwk", m, neigh)
    up = up.reshape(h, w, 4, 4).permute(0, 2, 1, 3).reshape(4 * h, 4 * w)
    return up * 4.0


class RaftStereoNet(nn.Module):
    def __init__(self, cfg: RaftStereoConfig):
        super().__init__()
        self.cfg = c = cfg
        self.fnet = Encoder(c.feat_dim)
        self.cnet = Encoder(c.hidden_dim + c.context_dim)
        self.update = UpdateBlock(c)

    def forward(self, left, right):
        """(H, W) grey images in [0, 1] -> the last iteration's full-
        resolution disparity (the reference also returns every
        iteration's, for its training loss)."""
        c = self.cfg
        with autotuned_convs():
            f = self.fnet(torch.stack([left, right])[:, None]).permute(0, 2, 3, 1)
            ctx = self.cnet(left[None, None])
            h = torch.tanh(ctx[:, : c.hidden_dim])
            context = F.relu(ctx[:, c.hidden_dim:])
            pyr = corr_pyramid(f[0], f[1], c.corr_levels)
            disp = torch.zeros(f.shape[1:3], dtype=torch.float32, device=left.device)
            for _ in range(c.iters):
                h, dd, mask = self.update(h, context, lookup(pyr, disp, c.corr_radius), disp)
                disp = torch.clamp(disp + dd, 0.0, c.max_disp / 4.0)
        return convex_upsample(disp, mask)


class RaftStereo:
    """Full-resolution disparity from a rectified pair, on ``device``."""

    def __init__(self, cfg: RaftStereoConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or RaftStereoConfig()
        self.device = torch.device(device)
        self.net = RaftStereoNet(self.cfg)
        self.trained = False
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        self.net.load_state_dict(interop.raft_stereo_state_dict(interop.read_npz(path)))
        self.trained = True

    def run(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """(h, w) grey images in [0, 1] on the device, multiples of 16."""
        with torch.no_grad():
            return self.net(left, right)

    def infer(self, left, right) -> np.ndarray:
        """(H, W) [0, 255] pair -> (H, W) disparity, 0 outside the crop to
        multiples of 16."""
        left = np.asarray(left, np.float32) / 255.0
        right = np.asarray(right, np.float32) / 255.0
        h, w = left.shape
        h4, w4 = (h // 16) * 16, (w // 16) * 16

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x[:h4, :w4])).to(self.device)

        d = self.run(put(left), put(right)).cpu().numpy()
        out = np.zeros((h, w), np.float32)
        out[:h4, :w4] = d
        return out
