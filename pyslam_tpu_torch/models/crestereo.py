"""CREStereo-class cascaded recurrent stereo (port of
``pyslam_tpu/models/crestereo.py``).

The RAFT encoder (``raft_stereo.Encoder``) on both images at 1/4
resolution, its maps average-pooled to 1/8; a cascade of two levels (1/8
from zero disparity, then 1/4 from the coarse result upsampled 2x with
``jax.image.resize``'s weights), each a few ConvGRU iterations over an
adaptive group correlation (``_group_corr_window``): the channels split
into groups, each correlated over a (2r + 1)-wide window around the
current disparity shifted by a learned per-pixel, per-group offset; then
the RAFT convex upsampling to full resolution.

``_group_corr_window`` copies the reference's border rule: the
interpolation fraction is taken from the floor before the indices are
clipped (``raft_stereo.lookup`` clips first).  The offsets depend only on
the context, so each level computes them once (the reference recomputes
the same values every iteration).  The modules carry the JAX package's
names.  Without a checkpoint (the JAX package's ``.npz``) the weights are
seeded random ones (``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import autotuned_convs, resize_hw
from pyslam_tpu_torch.models.raft_stereo import ConvGRU, Encoder, convex_upsample


@dataclass
class CREStereoConfig:
    feat_dim: int = 96
    hidden_dim: int = 96
    groups: int = 4
    radius: int = 4
    iters_coarse: int = 4
    iters_fine: int = 4
    max_disp: float = 192.0


def _group_corr_window(f1, f2, disp, offsets, radius: int, groups: int) -> torch.Tensor:
    """Adaptive group correlation over a local window.  f1, f2 (H, W, C);
    disp (H, W), positive = left shift; offsets (H, W, G) added to the
    window's centre per group -> (H, W, (2r + 1) * G), window-major."""
    H, W, C = f1.shape
    gch = C // groups
    f1g = f1.reshape(H, W, groups, gch)
    f2g = f2.reshape(H, W, groups, gch)
    xs = torch.arange(W, dtype=torch.float32, device=f1.device)[None, :, None]
    rows = torch.arange(H, device=f1.device)[:, None, None]
    g_idx = torch.arange(groups, device=f1.device)[None, None, :]
    inv_mean = float(np.float32(1.0) / np.float32(gch))
    inv_sqrt = float(np.float32(1.0) / np.float32(np.sqrt(gch)))
    out = []
    for dx in range(-radius, radius + 1):
        pos = xs - disp[..., None] + dx + offsets            # (H, W, G)
        x0 = torch.floor(pos)
        a = (pos - x0)[..., None]
        x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
        x1i = torch.clamp(x0i + 1, 0, W - 1)
        samp = f2g[rows, x0i, g_idx] * (1 - a) + f2g[rows, x1i, g_idx] * a
        out.append((f1g * samp).sum(-1) * inv_mean * inv_sqrt)
    return torch.cat(out, -1)


class AGCLUpdate(nn.Module):
    """One cascade level: the offset head and ``iters`` GRU refinements."""

    def __init__(self, cfg: CREStereoConfig, iters: int):
        super().__init__()
        self.cfg = c = cfg
        self.iters = iters
        n_corr = (2 * c.radius + 1) * c.groups
        self.offset_head = nn.Conv2d(c.hidden_dim, c.groups, 3, padding=1)
        self.corr_enc = nn.Conv2d(n_corr, 64, 1)
        self.disp_enc = nn.Conv2d(1, 32, 3, padding=1)
        self.gru = ConvGRU(c.hidden_dim, 64 + 32 + c.hidden_dim)
        self.delta_head = nn.Conv2d(c.hidden_dim, 1, 3, padding=1)

    def forward(self, f1, f2, context, h, disp):
        """f1, f2 (H, W, C); context, h (1, C, H, W); disp (H, W)."""
        c = self.cfg
        offsets = (torch.tanh(self.offset_head(context)) * 2.0)[0].permute(1, 2, 0)
        for _ in range(self.iters):
            corr = _group_corr_window(f1, f2, disp, offsets, c.radius, c.groups)
            cf = F.relu(self.corr_enc(corr.permute(2, 0, 1)[None]))
            df = F.relu(self.disp_enc(disp[None, None]))
            h = self.gru(h, torch.cat([cf, df, context], 1))
            disp = torch.clamp(disp + self.delta_head(h)[0, 0], 0.0, c.max_disp)
        return h, disp


class CREStereoNet(nn.Module):
    def __init__(self, cfg: CREStereoConfig):
        super().__init__()
        self.cfg = c = cfg
        self.fnet = Encoder(c.feat_dim)
        self.cnet = Encoder(2 * c.hidden_dim)
        self.level_coarse = AGCLUpdate(c, c.iters_coarse)
        self.level_fine = AGCLUpdate(c, c.iters_fine)
        self.up_mask = nn.Conv2d(c.hidden_dim, 16 * 9, 3, padding=1)

    def forward(self, left, right):          # (H, W) grey in [0, 1]
        c = self.cfg
        H, W = left.shape
        with autotuned_convs():
            f = self.fnet(torch.stack([left, right])[:, None])
            ctx4, h4 = self.cnet(left[None, None]).split(c.hidden_dim, 1)
            ctx4, h4 = F.relu(ctx4), torch.tanh(h4)

            def down2(x):
                return F.avg_pool2d(x, 2, stride=2)

            f8 = down2(f).permute(0, 2, 3, 1)
            f4 = f.permute(0, 2, 3, 1)
            ctx8, h8 = down2(ctx4), down2(h4)
            disp8 = torch.zeros(f8.shape[1:3], dtype=torch.float32, device=left.device)
            h8, disp8 = self.level_coarse(f8[0], f8[1], ctx8, h8, disp8)
            disp4 = 2.0 * resize_hw(disp8, tuple(f4.shape[1:3]))
            h4, disp4 = self.level_fine(f4[0], f4[1], ctx4, h4, disp4)
            mask = self.up_mask(h4)[0].permute(1, 2, 0)
        return convex_upsample(disp4, mask)[:H, :W]


class CREStereo:
    """Stereo disparity on ``device`` (the surface of ``RaftStereo``): each
    pair is zero-padded to the multiples of 8 of its size.  (The reference
    pads every pair to the size of its first, fixed for its compiled graph,
    or to 240 x 320 when its estimator loads a checkpoint: a larger pair
    then fails, a smaller one is padded further.)"""

    def __init__(self, cfg: CREStereoConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or CREStereoConfig()
        self.device = torch.device(device)
        self.net = CREStereoNet(self.cfg)
        self.trained = False
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        self.net.load_state_dict(interop.crestereo_state_dict(interop.read_npz(path)))
        self.trained = True

    def run(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.net(left, right)

    def infer(self, left, right) -> np.ndarray:
        left = np.asarray(left, np.float32)
        right = np.asarray(right, np.float32)
        if left.ndim == 3:
            left, right = left.mean(-1), right.mean(-1)
        if left.max() > 2.0:
            left, right = left / 255.0, right / 255.0
        h, w = ((left.shape[0] + 7) // 8) * 8, ((left.shape[1] + 7) // 8) * 8
        L = np.zeros((h, w), np.float32)
        R = np.zeros((h, w), np.float32)
        L[:left.shape[0], :left.shape[1]] = left
        R[:right.shape[0], :right.shape[1]] = right
        disp = self.run(torch.from_numpy(L).to(self.device),
                        torch.from_numpy(R).to(self.device)).cpu().numpy()
        return disp[:left.shape[0], :left.shape[1]]
