"""ContextDesc, context-augmented local descriptors (port of
``pyslam_tpu/models/contextdesc.py``).

Three towers re-describe a detector's keypoints (SIFT's in the
CONTEXTDESC preset):
- local: GeoDesc over oriented 32x32 patches, and a matchability head on
  its conv5 map (conv8x8 -> 1x1 32 -> 1x1 32 -> 1 -> dense, tanh);
- visual context: a regional conv encoder at stride 16, 1x1 layers with
  context normalisation (moments over the token set) and flax LayerNorm,
  3-NN inverse-distance interpolation at the keypoints (ties to the lower
  index, as ``jax.lax.top_k``), concatenated with the local descriptor,
  then an MLP 512-256-128;
- geometric context: [matchability, x, y] through 4 residual context-norm
  blocks to 128.
The output is l2(local + visual + geometric).  The context norms run over
every keypoint slot the detector hands over, valid or not, as the JAX
package's.  The modules carry the JAX package's names; its checkpoints
``{checkpoint}.{local,mb,reg,vis,geo}.npz`` are read by path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import conv_same, layer_norm
from pyslam_tpu_torch.models.patch_descriptors import BN, GeoDesc
from pyslam_tpu_torch.models.superpoint import _INV_255
from pyslam_tpu_torch.ops.nms import _topk_stable
from pyslam_tpu_torch.ops.patches import extract_oriented_patches


@dataclass(frozen=True)
class ContextDescConfig:
    reg_dim: int = 128                 # regional grid feature channels
    vis_dims: tuple = (256, 128)       # context-normalised 1x1 conv widths
    fuse_dims: tuple = (512, 256, 128)
    geo_dim: int = 128


def _context_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise over the token axis, per channel (biased std)."""
    mu = x.mean(0, keepdim=True)
    sd = torch.sqrt(((x - mu) ** 2).mean(0, keepdim=True))
    return (x - mu) / (sd + eps)


class MatchabilityHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.kpt_m_conv0 = nn.Conv2d(128, 128, 8, bias=False)
        self.kpt_m_bn0 = BN(128, affine=True)
        self.kpt_m_conv1 = nn.Conv2d(128, 32, 1)
        self.kpt_m_conv2 = nn.Conv2d(32, 32, 1)
        self.kpt_m = nn.Conv2d(32, 1, 1)
        self.fc = nn.Linear(1, 1)

    def forward(self, inter):                    # (N, 128, 8, 8) GeoDesc conv5
        x = F.relu(self.kpt_m_bn0(self.kpt_m_conv0(inter)))
        x = F.relu(self.kpt_m_conv1(x))
        x = F.relu(self.kpt_m_conv2(x))
        x = self.fc(self.kpt_m(x).flatten(1))
        return torch.tanh(x[:, 0])


class RegionalEncoder(nn.Module):
    def __init__(self, cfg: ContextDescConfig):
        super().__init__()
        cin = 1
        for i, ch in enumerate((32, 64, 128, cfg.reg_dim)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3, stride=2))
            cin = ch

    def forward(self, img):                      # (H, W) [0, 1] -> (C, h, w)
        x = img[None, None]
        for i in range(4):
            x = F.relu(conv_same(getattr(self, f"conv{i}"), x))
        return x[0]


class VisualContext(nn.Module):
    def __init__(self, cfg: ContextDescConfig):
        super().__init__()
        self.cfg = cfg
        cin = cfg.reg_dim
        for i, d in enumerate(cfg.vis_dims):
            self.add_module(f"conv{i + 1}", nn.Linear(cin, d))
            self.add_module(f"conv{i + 1}_bn", nn.LayerNorm(d, eps=1e-6))
            cin = d
        cin += 128
        for i, d in enumerate(cfg.fuse_dims):
            self.add_module(f"fuse_photo_context_{i}", nn.Linear(cin, d))
            cin = d

    def forward(self, grid_feat, grid_xy, local, kpt_xy):
        """grid_feat (G, D), grid_xy (G, 2) in [-1, 1], local (N, 128),
        kpt_xy (N, 2) in [-1, 1]."""
        x = grid_feat
        for i in range(len(self.cfg.vis_dims)):
            x = _context_norm(getattr(self, f"conv{i + 1}")(x))
            x = F.relu(layer_norm(getattr(self, f"conv{i + 1}_bn"), x))
        d2 = ((kpt_xy[:, None] - grid_xy[None]) ** 2).sum(-1)
        dist = torch.sqrt(d2 + 1e-6)
        nd, idx = _topk_stable(-dist, 3)                      # (N, 3)
        w = 1.0 / torch.clamp(-nd, min=1e-10)
        w = w / w.sum(1, keepdim=True)
        inter = (x[idx] * w[..., None]).sum(1)
        y = torch.cat([inter, local], -1)
        n = len(self.cfg.fuse_dims)
        for i in range(n):
            y = getattr(self, f"fuse_photo_context_{i}")(y)
            if i < n - 1:
                y = F.relu(y)
        return y


class GeoContext(nn.Module):
    """4 residual context-normalisation blocks over [kpt_m, kpt_xy]."""

    def __init__(self, cfg: ContextDescConfig):
        super().__init__()
        g = cfg.geo_dim
        self.dim_control = nn.Linear(3, g)
        for i in range(4):
            self.add_module(f"cn{i + 1}_bn", nn.LayerNorm(g, eps=1e-6))
            self.add_module(f"cn{i + 1}_conv", nn.Linear(g, g))
        self.context_trans = nn.Linear(g, g)

    def forward(self, kpt_m, kpt_xy):            # (N,), (N, 2)
        x = self.dim_control(torch.cat([kpt_m[:, None], kpt_xy], -1))
        for i in range(4):
            y = F.relu(layer_norm(getattr(self, f"cn{i + 1}_bn"), _context_norm(x)))
            x = x + getattr(self, f"cn{i + 1}_conv")(y)
        return self.context_trans(x)


class ContextDescExtractor:
    """Descriptor stage: re-describe any detector's keypoints on
    ``device``.  Without ``checkpoint`` seeded random weights (``trained =
    False``)."""

    PARTS = ("local", "mb", "reg", "vis", "geo")

    def __init__(self, cfg: ContextDescConfig | None = None, checkpoint: str | None = None,
                 seed: int = 0, *, device: torch.device | str = "cuda"):
        self.cfg = cfg or ContextDescConfig()
        self.device = torch.device(device)
        self.local = GeoDesc()
        self.mb_head = MatchabilityHead()
        self.regional = RegionalEncoder(self.cfg)
        self.vis = VisualContext(self.cfg)
        self.geo = GeoContext(self.cfg)
        self.trained = bool(checkpoint)
        for i, (part, net) in enumerate(zip(self.PARTS, self.nets())):
            if checkpoint:
                net.load_state_dict(interop.same_names_state_dict(
                    interop.read_npz(f"{checkpoint}.{part}.npz")))
            else:
                interop.seeded_init_(net, seed + i)
            net.to(self.device).eval()

    def nets(self):
        return self.local, self.mb_head, self.regional, self.vis, self.geo

    def compute(self, img: torch.Tensor, xys, sizes, angles) -> torch.Tensor:
        """(H, W) image on the device and the keypoints' (N, 2) centres,
        (N,) sizes and angles -> (N, 128) augmented descriptors."""
        if len(xys) == 0:
            return torch.zeros((0, 128), dtype=torch.float32, device=self.device)
        h, w = img.shape
        img01 = img * _INV_255
        with torch.no_grad():
            patches = extract_oriented_patches(img01, xys, sizes, angles, patch_size=32,
                                               mag_factor=3.0)
            local, inter = self.local(patches, return_inter=True)
            kpt_m = self.mb_head(inter)
            grid = self.regional(img01)                        # (C, gh, gw)
            gh, gw = grid.shape[1:]
            gy, gx = torch.meshgrid(torch.arange(gh, device=img.device),
                                    torch.arange(gw, device=img.device), indexing="ij")
            # XLA multiplies by the float32 reciprocal of a constant divisor
            grid_xy = torch.stack([2.0 * (gx.reshape(-1) + 0.5) * _inv(gw) - 1.0,
                                   2.0 * (gy.reshape(-1) + 0.5) * _inv(gh) - 1.0], 1)
            kxy = torch.stack([2.0 * xys[:, 0] * _inv(w) - 1.0,
                               2.0 * xys[:, 1] * _inv(h) - 1.0], 1)
            visf = self.vis(grid.reshape(grid.shape[0], -1).T, grid_xy, local, kxy)
            out = local + visf + self.geo(kpt_m, kxy)
            return out / torch.sqrt((out * out).sum(1, keepdim=True) + 1e-10)


def _inv(n: int) -> float:
    return float(np.float32(1.0) / np.float32(n))
