"""Incremental Gaussian-splatting dense mapping (port of
``pyslam_tpu/dense/gaussian_splatting_integrator.py``; reference: pySLAM's
GAUSSIAN_SPLATTING volumetric integrator over MonoGS).

- A fixed-capacity gaussian store on ``device``; seeding fills free slots.
- Per keyframe: render its pose, seed gaussians from its depth where the
  accumulated alpha is under 0.5 (every ``seed_stride`` pixels, thinned
  to the free slots by ``np.linspace``), then ``steps_per_kf`` Adam steps
  against the last ``window`` keyframe views (colour L1 + depth L1).  The
  Adam state lives on the volume, so its step count runs on across
  keyframes; ``reset()`` starts a new one.
- The TSDF volume's surface: ``integrate``, ``render``,
  ``extract_point_cloud``, ``save``/``load``, ``reset``, ``device`` and
  ``num_integrated``.

``integrate`` takes the integrator's ``phase`` and ``phases`` and does the
whole keyframe at the last phase (a departure: the reference's volume
takes neither, so its ``VolumetricIntegrator`` fails on the first
keyframe; ROADMAP.md section 3).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from pyslam_tpu_torch.ops import gaussian_splatting as gs


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class GaussianSplattingVolume:
    """Gaussian store and optimiser with the TSDF volume's surface."""

    def __init__(self, capacity: int = 60_000, render_hw=None, tile_k: int = 48,
                 steps_per_kf: int = 30, window: int = 3, seed_stride: int = 4,
                 depth_trunc: float = 20.0, channels: int = 1, *,
                 device: torch.device | str = "cuda"):
        self._device = torch.device(device)
        self.capacity = capacity
        self.tile_k = tile_k
        self.steps_per_kf = steps_per_kf
        self.window = window
        self.seed_stride = seed_stride
        self.depth_trunc = depth_trunc
        self.channels = channels
        self.render_hw = render_hw
        self._views: deque = deque(maxlen=window)
        self.reset()

    @property
    def device(self) -> torch.device:
        """Where the gaussians are."""
        return self.g.means.device

    # ------------------------------------------------------------- storage
    def reset(self):
        c, dev = self.capacity, self._device
        self.g = gs.Gaussians(
            means=torch.zeros((c, 3), device=dev),
            log_scales=torch.full((c, 3), -10.0, device=dev),
            quats=torch.tensor([1.0, 0, 0, 0], device=dev).repeat(c, 1),
            opacity_logit=torch.full((c,), -10.0, device=dev),
            colors=torch.zeros((c, self.channels), device=dev),
            valid=torch.zeros((c,), dtype=torch.bool, device=dev),
        )
        self.num_used = 0
        self.num_integrated = 0
        self.opt_state = None
        self._views.clear()

    def _insert(self, seeds: dict) -> int:
        n = len(seeds["means"])
        free = self.capacity - self.num_used
        if n > free:
            # thin the incoming seeds to the free budget
            sel = np.linspace(0, n - 1, free).astype(int) if free > 0 else []
            seeds = {k: v[sel] for k, v in seeds.items()}
            n = len(seeds["means"])
        if n == 0:
            return 0
        s, e = self.num_used, self.num_used + n
        # written into the same leaves: the Adam moments of these slots were
        # zero (their parameters never moved) and stay with the volume
        with torch.no_grad():
            for name in gs.TRAINABLE:
                getattr(self.g, name)[s:e] = torch.from_numpy(
                    np.asarray(seeds[name], np.float32)).to(self.device)
            self.g.valid[s:e] = True
        self.num_used = e
        return n

    # ----------------------------------------------------------- integrate
    def _prep(self, img, depth):
        h, w = img.shape[:2]
        if self.render_hw is None:
            # crop to tile multiples; the first keyframe fixes the raster size
            self.render_hw = ((h // gs.TILE) * gs.TILE, (w // gs.TILE) * gs.TILE)
        rh, rw = self.render_hw
        img_c = np.asarray(img, np.float32)[:rh, :rw]
        if img_c.ndim == 2:
            img_c = img_c[..., None]
        return img_c / 255.0, np.asarray(depth, np.float32)[:rh, :rw]

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def integrate(self, depth, intensity, Twc, K, phase: int = 0, phases: int = 1):
        """Seed and optimise with one keyframe (host or device depth and
        intensity); the work runs at ``phase == phases - 1``."""
        if phase != phases - 1:
            return
        img_t, dep_t = self._prep(_host(intensity), _host(depth))
        rh, rw = self.render_hw
        Twc = np.asarray(Twc)
        Tcw = np.linalg.inv(Twc)
        K = np.asarray(K)
        # coverage-gated seeding: only the pixels the model does not explain
        if self.num_used > 0:
            with torch.no_grad():
                _, acc, _ = gs.rasterize(self.g, self._tensor(Tcw), self._tensor(K), rh, rw,
                                         self.tile_k)
            need = acc.cpu().numpy() < 0.5
        else:
            need = np.ones((rh, rw), bool)
        seeds = gs.seed_from_depth(np.where(need, dep_t, 0.0), img_t[..., 0] * 255.0, Twc, K,
                                   stride=self.seed_stride, max_depth=self.depth_trunc)
        self._insert(seeds)
        self._views.append((np.asarray(Tcw, np.float32), img_t.astype(np.float32),
                            np.where(dep_t < self.depth_trunc, dep_t, 0.0).astype(np.float32)))
        self._optimize(K)
        self.num_integrated += 1

    def _optimize(self, K) -> float:
        rh, rw = self.render_hw
        Tcws, targets, depths = (self._tensor(np.stack([v[i] for v in self._views]))
                                 for i in range(3))
        self.g, self.opt_state, losses = gs.optimize_gaussians(
            self.g, self.opt_state, Tcws, self._tensor(K), targets, depths, rh, rw,
            self.tile_k, self.steps_per_kf)
        return float(losses[-1])

    def render(self, Tcw, K):
        """Host (colour (h, w, C), alpha (h, w), depth (h, w)) at ``Tcw``."""
        rh, rw = self.render_hw
        with torch.no_grad():
            out = gs.rasterize(self.g, self._tensor(Tcw), self._tensor(K), rh, rw, self.tile_k)
        return tuple(o.cpu().numpy() for o in out)

    # -------------------------------------------------------------- output
    def extract_point_cloud(self):
        n = self.num_used
        pts = self.g.means[:n].detach().cpu().numpy()
        cols = self.g.colors[:n].detach().cpu().numpy()
        keep = self.g.opacity_logit[:n].detach().cpu().numpy() > -2.0   # prune transparent
        return pts[keep], np.repeat(cols[keep], 3, axis=1)[:, :3] * 255.0

    def save(self, path: str):
        n = self.num_used
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            **{name: getattr(self.g, name)[:n].detach().cpu().numpy() for name in gs.TRAINABLE},
            render_hw=np.asarray(self.render_hw if self.render_hw else (0, 0)))

    def load(self, path: str):
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            self.reset()
            hw = tuple(int(x) for x in z["render_hw"])
            self.render_hw = hw if hw != (0, 0) else None
            self._insert({k: z[k] for k in gs.TRAINABLE})
