"""DepthAnything 3-class any-view depth and ray model (port of
``pyslam_tpu/models/depth_anything_v3.py``).

One plain transformer over any number of views: a patch embedding with a
learned position embedding, then VGGT blocks (``models.vggt._Block``) that
attend within each view (even blocks) or across the concatenation of all
views' tokens (odd blocks).  A dual DPT head (``DualDPTHead``) fuses four
taps coarse to fine (``depth_anything_v2.FusionBlock``) and predicts per
pixel a softplus depth, a sigmoid confidence and a ray (origin, unit
direction) in the first view's frame.  ``recover_camera_from_rays``
(host numpy, the reference's) recovers each view's camera from its rays:
the focal that minimises the Kabsch residual, the rotation, the mean ray
origin.  The modules carry the JAX package's names.  Without a checkpoint
(the JAX package's ``.npz``) the weights are seeded random ones
(``trained = False``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.depth_anything_v2 import FusionBlock
from pyslam_tpu_torch.models.layers import autotuned_convs, resize_hw, softplus
from pyslam_tpu_torch.models.vggt import _Block


@dataclass(frozen=True)
class DA3Config:
    img_hw: tuple = (224, 224)
    patch: int = 16
    dim: int = 384
    depth: int = 12          # total blocks; odd ones attend cross-view
    heads: int = 6
    taps: tuple = (2, 5, 8, 11)
    features: int = 64       # dual-DPT fusion width


class DualDPTHead(nn.Module):
    """A shared fusion pyramid with two output branches: (depth, conf) and
    (ray origin, ray direction)."""

    def __init__(self, cfg: DA3Config):
        super().__init__()
        self.cfg = c = cfg
        for j in range(len(c.taps)):
            self.add_module(f"project_{j}", nn.Conv2d(c.dim, c.features, 1))
        for r in range(1, 5):
            self.add_module(f"refine{r}", FusionBlock(c.features, skip=r < 4))
        self.depth_conv = nn.Conv2d(c.features, 32, 3, padding=1)
        self.depth_out = nn.Conv2d(32, 2, 1)
        self.ray_conv = nn.Conv2d(c.features, 32, 3, padding=1)
        self.ray_out = nn.Conv2d(32, 6, 1)

    def forward(self, taps, hp: int, wp: int):   # taps: (V, N, D) each
        c = self.cfg
        V = taps[0].shape[0]
        feats = []
        for j, tap in enumerate(taps):
            f = getattr(self, f"project_{j}")(tap.transpose(1, 2).reshape(V, c.dim, hp, wp))
            scale = (4, 2, 1, 0.5)[j]
            feats.append(resize_hw(f, (int(hp * scale), int(wp * scale))))
        l1, l2, l3, l4 = feats
        p4 = self.refine4(l4, out_hw=l3.shape[-2:])
        p3 = self.refine3(p4, l3, out_hw=l2.shape[-2:])
        p2 = self.refine2(p3, l2, out_hw=l1.shape[-2:])
        p1 = self.refine1(p2, l1)
        y = resize_hw(p1, tuple(c.img_hw))
        d = self.depth_out(F.relu(self.depth_conv(y)))
        r = self.ray_out(F.relu(self.ray_conv(y))).permute(0, 2, 3, 1)
        direction = r[..., 3:]
        direction = direction / torch.clamp(
            torch.linalg.vector_norm(direction, dim=-1, keepdim=True), min=1e-8)
        return softplus(d[:, 0]), torch.sigmoid(d[:, 1]), r[..., :3], direction


class DA3Net(nn.Module):
    def __init__(self, cfg: DA3Config):
        super().__init__()
        self.cfg = c = cfg
        n = (c.img_hw[0] // c.patch) * (c.img_hw[1] // c.patch)
        self.patch_embed = nn.Conv2d(3, c.dim, c.patch, stride=c.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, n, c.dim))
        for i in range(c.depth):
            self.add_module(f"view_{i}" if i % 2 == 0 else f"cross_{i}", _Block(c.dim, c.heads))
        self.head = DualDPTHead(c)

    def forward(self, imgs):                 # (V, H, W, 3) ImageNet-normalised
        c = self.cfg
        V = imgs.shape[0]
        hp, wp = c.img_hw[0] // c.patch, c.img_hw[1] // c.patch
        t = self.patch_embed(imgs.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        t = t + self.pos_embed
        taps = []
        for i in range(c.depth):
            if i % 2 == 0:
                t = getattr(self, f"view_{i}")(t)
            else:
                t = getattr(self, f"cross_{i}")(t.reshape(1, -1, c.dim)).reshape(V, -1, c.dim)
            if i in c.taps:
                taps.append(t)
        with autotuned_convs():
            return self.head(taps, hp, wp)


def recover_camera_from_rays(origin, direction, hw):
    """Camera of a view from its predicted ray map (host numpy, the
    reference's search): ``origin``, ``direction`` (H, W, 3) in the world
    (view 0) frame -> (Twc 4x4 camera-to-world, focal estimate in px).

    The camera-frame direction of pixel (u, v) for a focal f is
    [(u - cx) / f, (v - cy) / f, 1]; Kabsch on the unit vectors gives the
    rotation for a candidate f, and the focal minimising the residual is
    found on a log-spaced grid and refined by 20 ternary-search steps."""
    H, W = hw
    vs, us = np.mgrid[0:H, 0:W]
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    d = direction.reshape(-1, 3)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)

    def kabsch(f):
        c = np.stack([(us - cx).ravel() / f, (vs - cy).ravel() / f, np.ones(H * W)], axis=1)
        c = c / np.linalg.norm(c, axis=1, keepdims=True)
        M = c.T @ d
        U, _, Vt = np.linalg.svd(M)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T          # cam -> world
        return R, np.linalg.norm(c @ R.T - d)

    fs = np.geomspace(0.2 * W, 5.0 * W, 24)
    j = int(np.argmin([kabsch(f)[1] for f in fs]))
    lo, hi = fs[max(0, j - 1)], fs[min(len(fs) - 1, j + 1)]
    for _ in range(20):
        m1, m2 = lo + (hi - lo) / 3, hi - (hi - lo) / 3
        if kabsch(m1)[1] < kabsch(m2)[1]:
            hi = m2
        else:
            lo = m1
    f = 0.5 * (lo + hi)
    R, _ = kabsch(f)
    Twc = np.eye(4)
    Twc[:3, :3] = R
    Twc[:3, 3] = origin.reshape(-1, 3).mean(axis=0)
    return Twc, float(f)


_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
_IMAGENET_STD = np.array([0.229, 0.224, 0.225])


class DepthAnything3:
    """Any-view facade on ``device``: images -> depth, confidence, rays and
    the recovered cameras."""

    def __init__(self, cfg: DA3Config | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or DA3Config()
        self.device = torch.device(device)
        self.net = DA3Net(self.cfg)
        self.trained = False
        if checkpoint:
            self.net.load_state_dict(interop.da3_state_dict(interop.read_npz(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def _prep(self, img) -> np.ndarray:
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        h, w = self.cfg.img_hw
        ys = np.clip((np.arange(h) * img.shape[0] / h).astype(int), 0, img.shape[0] - 1)
        xs = np.clip((np.arange(w) * img.shape[1] / w).astype(int), 0, img.shape[1] - 1)
        img = img[np.ix_(ys, xs)]
        if img.max() > 2.0:
            img = img / 255.0
        return (img - _IMAGENET_MEAN) / _IMAGENET_STD

    def run(self, images: list):
        """The network's (depth, conf, origin, direction) on the device."""
        batch = np.stack([self._prep(im) for im in images]).astype(np.float32)
        with torch.no_grad():
            return self.net(torch.from_numpy(batch).to(self.device))

    def inference(self, images: list) -> dict:
        """-> dict(depth (V, H, W), conf, origin, direction, points (V, H,
        W, 3) in the world frame, poses (V, 4, 4) camera-to-world, focals
        (V,)), host arrays."""
        depth, conf, origin, direction = (o.cpu().numpy() for o in self.run(images))
        points = origin + depth[..., None] * direction
        poses, focals = [], []
        for v in range(len(images)):
            Twc, f = recover_camera_from_rays(origin[v], direction[v], self.cfg.img_hw)
            poses.append(Twc)
            focals.append(f)
        return {"depth": depth, "conf": conf, "origin": origin, "direction": direction,
                "points": points, "poses": np.stack(poses), "focals": np.array(focals)}
