"""(A)KAZE: nonlinear-diffusion scale space, Hessian keypoints, M-LDB
(AKAZE) or SURF-like 64-float (KAZE) descriptors (port of
``pyslam_tpu/features/akaze.py``).

  * scale space: L <- L + tau * div(g(|grad L|) grad L) with the
    Perona-Malik g2 conductivity 1 / (1 + |grad|^2 / k^2), ``sublevels``
    diffusion targets of ``steps_per`` explicit steps (tau = 0.24), k the
    70th percentile of the input's gradient magnitudes;
  * detector: sigma-normalised det(Hessian) per sublevel, the maximum
    across sublevels, grid top-k; four octaves (2x2 average pooling), the
    global top-n by response;
  * orientation: the intensity centroid over a 7-sigma disc;
  * AKAZE M-LDB: rotated grids of 2x2 / 3x3 / 4x4 cells, per cell the mean
    intensity and mean rotated dx, dy, every cell pair compared per
    channel -> 486 bits (int8 bit-planes);
  * KAZE: 4x4 x (sum dx, sum |dx|, sum dy, sum |dy|) of the diffused
    gradients over a rotated 20x20 grid -> 64 floats, L2-normalised.

The 24 explicit diffusion steps are rounded as the reference's compiled CPU
code rounds them: the squared gradient, the flux sum and the update are
fused multiply-adds (``fma32``), the conductivity divides by k^2 truly,
the square root is correctly rounded (computed in float64), and the
percentile interpolates as ``jnp.quantile`` does.  So the scale space, the
responses and the keypoints are the reference's bit for bit; orientation
and descriptors go through the device's trigonometry.
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.features.orb2 import FeatureData
from pyslam_tpu_torch.ops import image as image_ops
from pyslam_tpu_torch.ops import nms as nms_ops
from pyslam_tpu_torch.ops.patches import _bilinear_gather
from pyslam_tpu_torch.ops.voxel_hash import fma32

_INV_255 = float(np.float32(1.0 / 255.0))   # XLA's reciprocal of a constant divisor


def _shift(x, dy, dx):
    return torch.roll(x, (dy, dx), (-2, -1))


def _grad(x):
    dx = 0.5 * (_shift(x, 0, -1) - _shift(x, 0, 1))
    dy = 0.5 * (_shift(x, -1, 0) - _shift(x, 1, 0))
    return dx, dy


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (the CPU's vectorised float32
    sqrt is not)."""
    return torch.sqrt(x.double()).float()


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` with linear interpolation, rounded as the
    reference computes it in float32: position q * (n - 1), the two
    neighbouring order statistics, low * (1 - w) + high * w fused."""
    a = torch.sort(x.reshape(-1)).values
    n = a.shape[0]
    pos = np.float32(q) * np.float32(n - 1)
    low = np.floor(pos)
    high = np.ceil(pos)
    hw = np.float32(pos - low)
    lw = np.float32(np.float32(1.0) - hw)
    lo = a[int(min(max(low, 0), n - 1))]
    hi = a[int(min(max(high, 0), n - 1))]
    return fma32(lo, torch.tensor(lw, device=x.device), hi * float(hw))


def nonlinear_scale_space(img: torch.Tensor, sublevels: int = 4, steps_per: int = 6,
                          k: torch.Tensor | float | None = None, tau: float = 0.24):
    """(H, W) [0, 1] -> ((S, H, W) diffused stack, per-sublevel sigmas).
    ``k`` (the Perona-Malik contrast) defaults to the 70th percentile of
    the input's gradient magnitudes (at least 1e-4)."""
    L = img
    if k is None:
        dx0, dy0 = _grad(L)
        mag = _sqrt(fma32(dx0, dx0, dy0 * dy0))
        k = torch.clamp(quantile_linear(mag, 0.7), min=1e-4)
    k = torch.as_tensor(k, dtype=torch.float32, device=img.device)
    kk = k * k
    tau_t = torch.tensor(tau, dtype=torch.float32, device=img.device)
    outs = []
    for _ in range(sublevels):
        for _ in range(steps_per):
            dx, dy = _grad(L)
            g = 1.0 / (1.0 + fma32(dx, dx, dy * dy) / kk)
            # divergence of g * grad via half-point fluxes
            ce = 0.5 * (g + _shift(g, 0, -1))
            cw = 0.5 * (g + _shift(g, 0, 1))
            cs = 0.5 * (g + _shift(g, -1, 0))
            cn = 0.5 * (g + _shift(g, 1, 0))
            tot = fma32(ce, _shift(L, 0, -1) - L, cw * (_shift(L, 0, 1) - L))
            tot = fma32(cs, _shift(L, -1, 0) - L, tot)
            tot = fma32(cn, _shift(L, 1, 0) - L, tot)
            L = fma32(tau_t, tot, L)
        outs.append(L)
    sigmas = np.sqrt(2.0 * tau * steps_per * np.arange(1, sublevels + 1))
    return torch.stack(outs), sigmas


def _hessian_response(L, sigma: float):
    dx, dy = _grad(L)
    dxx, dxy = _grad(dx)
    _, dyy = _grad(dy)
    return float(np.float32(sigma ** 4)) * fma32(dxx, dyy, -(dxy * dxy))


def _mldb_pairs(cells: int):
    iu, ju = np.triu_indices(cells, 1)
    return iu.astype(np.int64), ju.astype(np.int64)


def _cell_sums16(val: torch.Tensor) -> torch.Tensor:
    """(N, 400) samples of the 20x20 grid -> (N, 16) sums over its 4x4
    cells of 5x5 samples, in sample order."""
    n = val.shape[0]
    v = val.reshape(n, 4, 5, 4, 5).permute(0, 1, 3, 2, 4).reshape(n, 16, 25)
    acc = v[..., 0]
    for i in range(1, 25):
        acc = acc + v[..., i]
    return acc


def _gather_levels(stack: torch.Tensor, li: torch.Tensor, px: torch.Tensor,
                   py: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (N, P) of each keypoint's own sublevel ``li`` (N,)
    of a (S, H, W) stack."""
    return _bilinear_gather(stack, px, py, level=li[:, None])


def _pool2(img01: torch.Tensor, raw: torch.Tensor | None = None) -> torch.Tensor:
    """2x2 average pool (cropped to even dimensions) in the reference's
    rounding: the compiled reduction keeps one partial sum per row of the
    2x2 block, (q00 + q01) + (q10 + q11), then scales by 0.25.  For the
    first octave the division by 255 is fused into the sum (``raw`` is the
    undivided image): each partial sum is fma(q01, 1/255, q00 / 255)."""
    he, we = (img01.shape[0] // 2) * 2, (img01.shape[1] // 2) * 2
    if raw is None:
        q = img01[:he, :we].reshape(he // 2, 2, we // 2, 2)
        return ((q[:, 0, :, 0] + q[:, 0, :, 1]) + (q[:, 1, :, 0] + q[:, 1, :, 1])) * 0.25
    q = raw[:he, :we].reshape(he // 2, 2, we // 2, 2)
    inv = torch.tensor(_INV_255, dtype=torch.float32, device=raw.device)
    top = fma32(q[:, 0, :, 1], inv, q[:, 0, :, 0] * _INV_255)
    bottom = fma32(q[:, 1, :, 1], inv, q[:, 1, :, 0] * _INV_255)
    return (top + bottom) * 0.25


class AkazeExtractor:
    """(A)KAZE keypoints + descriptors with the FeatureData contract, on
    ``device`` (the card unless the caller asks for another).

    descriptor='MLDB' (AKAZE, 486-bit int8 planes) or 'KAZE' (64-float)."""

    def __init__(self, num_features: int = 1000, descriptor: str = "MLDB",
                 sublevels: int = 4, nms_cell: int = 8, octaves: int = 4, *,
                 device: torch.device | str = "cuda"):
        assert descriptor in ("MLDB", "KAZE")
        self.num_features = num_features
        self.descriptor = descriptor
        self.sublevels = sublevels
        self.nms_cell = nms_cell
        self.octaves = octaves
        self.device = torch.device(device)
        # 'level' in FeatureData = octave index
        self.scale_factors = (2.0 ** np.arange(octaves)).astype(np.float32)
        self.sigma2 = self.scale_factors ** 2
        self.inv_sigma2 = 1.0 / self.sigma2
        self._grids = [(_mldb_pairs(g * g), g) for g in (2, 3, 4)]

    # ------------------------------------------------------------ octave
    def _octave(self, img01: torch.Tensor, n: int):
        """Detect and describe on one octave; octave-local results."""
        dev = img01.device
        h, w = img01.shape
        stack, sigmas = nonlinear_scale_space(img01, self.sublevels)
        resp = torch.stack([_hessian_response(stack[s], float(sigmas[s]))
                            for s in range(self.sublevels)])
        best = resp.amax(0)
        lvl = torch.argmax(resp, 0)               # first sublevel on ties
        xy, score, valid = nms_ops.grid_topk_keypoints(best[None], cell=self.nms_cell,
                                                       per_cell=4, max_out=n)
        xy, score, valid = xy[0], score[0], valid[0]
        xi = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1)
        yi = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1)
        klvl = lvl[yi, xi]
        ksig = torch.as_tensor(sigmas.astype(np.float32), device=dev)[klvl]
        grads = [_grad(stack[s]) for s in range(self.sublevels)]
        dx_stack = torch.stack([g[0] for g in grads])
        dy_stack = torch.stack([g[1] for g in grads])
        x = xy[:, 0][:, None]
        y = xy[:, 1][:, None]
        s = ksig[:, None]

        # orientation: intensity centroid over a 7-sigma disc
        og = torch.linspace(-1.0, 1.0, 13, device=dev)
        ov, ou = torch.meshgrid(og, og, indexing="ij")
        ou = ou.reshape(-1)[None]
        ov = ov.reshape(-1)[None]
        odisc = ((ou * ou + ov * ov) <= 1.0).to(torch.float32)
        rad = 7.0 * s
        mi = _gather_levels(stack, klvl, fma32(ou, rad, x), fma32(ov, rad, y)) * odisc
        angs = torch.atan2((mi * ov).sum(1), (mi * ou).sum(1))
        cos = torch.cos(angs)[:, None]
        sin = torch.sin(angs)[:, None]
        r = fma32(torch.tensor(10.0, device=dev), s, torch.tensor(3.0, device=dev))

        if self.descriptor == "MLDB":
            bits = []
            for (iu, ju), g in self._grids:
                c = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g - 0.5
                v, u = torch.meshgrid(c, c, indexing="ij")
                off = torch.tensor([-0.25, 0.25], dtype=torch.float32, device=dev) / g
                dv, du = torch.meshgrid(off, off, indexing="ij")
                uu = (u.reshape(-1)[:, None] + du.reshape(-1)[None, :]).reshape(-1)[None]
                vv = (v.reshape(-1)[:, None] + dv.reshape(-1)[None, :]).reshape(-1)[None]
                px = x + (cos * uu - sin * vv) * 2 * r
                py = y + (sin * uu + cos * vv) * 2 * r
                mi = _gather_levels(stack, klvl, px, py)
                gx = _gather_levels(dx_stack, klvl, px, py)
                gy = _gather_levels(dy_stack, klvl, px, py)
                rgx = cos * gx + sin * gy
                rgy = -sin * gx + cos * gy
                iu_t = torch.as_tensor(iu, device=dev)
                ju_t = torch.as_tensor(ju, device=dev)
                for ch in (mi, rgx, rgy):
                    cm = ch.reshape(-1, g * g, 4).mean(2)
                    bits.append((cm[:, iu_t] < cm[:, ju_t]).to(torch.int8))
            desc = torch.cat(bits, 1)
        else:
            gi = (torch.arange(20, dtype=torch.float32, device=dev) - 9.5) / 20.0
            v, u = torch.meshgrid(gi, gi, indexing="ij")
            u = u.reshape(-1)[None]
            v = v.reshape(-1)[None]
            px = x + (cos * u - sin * v) * 2 * r
            py = y + (sin * u + cos * v) * 2 * r
            gx = _gather_levels(dx_stack, klvl, px, py)
            gy = _gather_levels(dy_stack, klvl, px, py)
            rdx = cos * gx + sin * gy
            rdy = -sin * gx + cos * gy
            f = torch.stack([_cell_sums16(rdx), _cell_sums16(rdx.abs()),
                             _cell_sums16(rdy), _cell_sums16(rdy.abs())], 2).reshape(-1, 64)
            desc = f / torch.clamp(torch.linalg.norm(f, dim=1, keepdim=True), min=1e-9)
        return xy, score, valid, desc, angs, ksig

    def extract(self, img: torch.Tensor) -> FeatureData:
        """(H, W) float32 image on the device -> FeatureData: the global
        top-n over all octaves, in level-0 coordinates."""
        dev = img.device
        n = self.num_features
        img01 = img * _INV_255
        parts = []
        raw = img
        for o in range(self.octaves):
            f = 2.0 ** o
            if min(img01.shape) >= 2 * self.nms_cell:
                xy, score, valid, desc, angs, ksig = self._octave(img01, n)
                neg = torch.full_like(score, float("-inf"))
                parts.append((xy * f + (f - 1.0) * 0.5, torch.where(valid, score, neg), valid,
                              desc, angs, ksig * f,
                              torch.full(score.shape, o, dtype=torch.int64, device=dev)))
            img01 = _pool2(img01, raw)
            raw = None
        cat = [torch.cat([p[i] for p in parts]) for i in range(7)]
        xy, score, valid, desc, angs, ksig, octv = cat
        top_score, top_i = torch.sort(score, descending=True, stable=True)
        top_score, top_i = top_score[:n], top_i[:n]
        valid = valid[top_i] & torch.isfinite(top_score)
        sizes = fma32(torch.tensor(20.0, device=dev), ksig[top_i], torch.tensor(6.0, device=dev))
        return FeatureData(
            xy=xy[top_i], level=octv[top_i],
            angle=torch.remainder(torch.rad2deg(angs[top_i]), 360.0), size=sizes,
            response=torch.where(valid, top_score, torch.zeros_like(top_score)),
            desc=desc[top_i], valid=valid)

    def __call__(self, img) -> FeatureData:
        """(H, W) grey (or (H, W, 3)) image -> FeatureData on ``device``."""
        return self.extract(image_ops.gray_image(img, self.device))
