"""Classical binary descriptors: BRISK, FREAK, BEBLID (port of
``pyslam_tpu/features/binary_descriptors.py``).

Each descriptor is a batched gather and compare over a static sampling
pattern:

  * BRISK: a 60-point concentric-ring pattern, each point sampled from a
    Gaussian blur matched to its ring's sigma; long pairs vote for the
    orientation, the 512 shortest pairs are thresholded into bits;
  * FREAK: a 43-point retinal pattern, the orientation from 45 symmetric
    pairs, 512 coarse-to-fine pairs;
  * BEBLID: pairs of boxes compared by mean intensity, four taps each into
    one integral image; the box set is the reference's seeded one
    (``default_rng(11)``), not the trained weak learners.

All three return unpacked (N, 512) int8 bit-planes on the keypoints'
device, the layout ``ops.hamming`` matches with one product.  The integral
image is summed in the reference's order (``image.integral_image``), and
the bilinear taps are rounded as its compiled code rounds them; the blur
stack's convolution and the orientation's trigonometry are the device's
own, so BRISK and FREAK bits agree with the reference except on near-ties
of the compared samples.
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.features.orb2 import FeatureData, ORB2Extractor, stereo_match
from pyslam_tpu_torch.ops import image as image_ops
from pyslam_tpu_torch.ops.patches import _bilinear_gather


# ----------------------------------------------------------------- patterns
def brisk_pattern():
    """(pts (60, 3): x, y, sigma), short pairs (512, 2), long pairs (L, 2)."""
    rings = [(0.0, 1), (2.9, 10), (4.9, 14), (7.4, 15), (10.8, 20)]
    pts = []
    for ri, (r, n) in enumerate(rings):
        sigma = max(0.55, 0.55 + 0.45 * r / 4.0)
        for i in range(n):
            a = 2 * np.pi * i / n + (np.pi / n if ri % 2 else 0.0)
            pts.append((r * np.cos(a), r * np.sin(a), sigma))
    pts = np.array(pts, np.float32)
    d = np.linalg.norm(pts[None, :, :2] - pts[:, None, :2], axis=-1)
    iu, ju = np.triu_indices(len(pts), 1)
    dist = d[iu, ju]
    order = np.argsort(dist)
    short = np.stack([iu[order[:512]], ju[order[:512]]], 1)
    long_mask = dist > 9.0
    long_pairs = np.stack([iu[long_mask], ju[long_mask]], 1)
    return pts, short.astype(np.int32), long_pairs.astype(np.int32)


def freak_pattern():
    """43-point retinal pattern + 512 coarse-to-fine pairs + 45
    orientation pairs (symmetric about the centre)."""
    pts = [(0.0, 0.0, 0.4)]
    radii = [10.0, 7.8, 6.0, 4.5, 3.2, 2.2, 1.4]
    for ri, r in enumerate(radii):
        sigma = max(0.45, r * 0.28)
        for i in range(6):
            a = 2 * np.pi * i / 6 + (np.pi / 6 if ri % 2 else 0.0)
            pts.append((r * np.cos(a), r * np.sin(a), sigma))
    pts = np.array(pts, np.float32)          # 43 points
    n = len(pts)
    iu, ju = np.triu_indices(n, 1)
    # coarse-to-fine: order pairs by decreasing combined sigma
    sig = pts[iu, 2] + pts[ju, 2]
    order = np.argsort(-sig)
    pairs = np.stack([iu[order[:512]], ju[order[:512]]], 1)
    # orientation pairs: long symmetric-ish pairs through the centre
    opp = np.abs((pts[iu, :2] + pts[ju, :2])).sum(1)
    oorder = np.argsort(opp)
    ori_pairs = np.stack([iu[oorder[:45]], ju[oorder[:45]]], 1)
    return pts, pairs.astype(np.int32), ori_pairs.astype(np.int32)


def beblid_boxes(bits: int = 512, seed: int = 11, patch_r: float = 12.0):
    """(bits, 2, 3): per bit two boxes (cx, cy, half-size)."""
    rng = np.random.default_rng(seed)
    sizes = rng.uniform(1.0, 4.5, (bits, 2, 1))
    lim = patch_r - sizes[..., 0] - 0.5
    pos = rng.uniform(-1.0, 1.0, (bits, 2, 2)) * lim[..., None]
    return np.concatenate([pos, sizes], axis=-1).astype(np.float32)


# -------------------------------------------------------------- blur stack
def _gauss_kernel(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(sigma, 1e-3)) ** 2)
    return k / k.sum()


def _conv_valid(x: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    """'valid' correlation of ``x`` with the symmetric kernel ``k`` along
    ``dim`` (a convolution, ``k`` being symmetric)."""
    n = x.shape[dim] - len(k) + 1
    acc = x.narrow(dim, 0, n) * float(k[0])
    for i in range(1, len(k)):
        acc = acc + x.narrow(dim, i, n) * float(k[i])
    return acc


def blur_stack(img: torch.Tensor, sigmas) -> torch.Tensor:
    """(H, W) -> (S, H, W): separable Gaussian blurs with edge padding,
    columns then rows (static sigma set)."""
    outs = []
    for s in sigmas:
        r = max(1, int(3 * s + 0.5))
        k = _gauss_kernel(s, r)
        x = torch.nn.functional.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
        x = _conv_valid(x, k, 0)
        x = torch.nn.functional.pad(x[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
        outs.append(_conv_valid(x, k, 1))
    return torch.stack(outs)


_SIGMA_SET = (0.6, 1.1, 1.9, 3.2)


def _nearest_sigma_idx(sigmas):
    s = np.asarray(_SIGMA_SET)
    return np.argmin(np.abs(s[None, :] - np.asarray(sigmas)[:, None]), 1)


# ------------------------------------------------------------- descriptors
class PatternBinaryDescriptor:
    """Shared BRISK/FREAK engine: blur stack + pattern gather + compares."""

    def __init__(self, kind: str = "BRISK", base_size: float = 31.0):
        assert kind in ("BRISK", "FREAK")
        self.kind = kind
        self.base_size = base_size
        pts, pairs, ori_pairs = brisk_pattern() if kind == "BRISK" else freak_pattern()
        self._pts = pts[:, :2]
        self._lvl = _nearest_sigma_idx(pts[:, 2])
        self._pairs = pairs
        self._ori = ori_pairs

    def _sample(self, blurs, x, y, s, cos, sin):
        """(N, P) blurred samples of the rotated, scaled pattern."""
        dev = blurs.device
        pts = torch.as_tensor(self._pts, device=dev)
        px = pts[None, :, 0] * s[:, None]
        py = pts[None, :, 1] * s[:, None]
        rx = cos[:, None] * px - sin[:, None] * py + x[:, None]
        ry = sin[:, None] * px + cos[:, None] * py + y[:, None]
        vals = torch.zeros_like(rx)
        for li in range(len(_SIGMA_SET)):
            idx = np.flatnonzero(self._lvl == li)
            if len(idx) == 0:
                continue
            it = torch.as_tensor(idx, device=dev)
            vals[:, it] = _bilinear_gather(blurs[li], rx[:, it], ry[:, it])
        return vals

    def oriented_samples(self, img: torch.Tensor, xys: torch.Tensor, sizes: torch.Tensor):
        """(N, P) samples of the pattern rotated to each keypoint's
        orientation, and the (N,) orientations in radians."""
        dev = img.device
        blurs = blur_stack(img, _SIGMA_SET)
        x = xys[:, 0].to(torch.float32)
        y = xys[:, 1].to(torch.float32)
        # XLA divides by a constant as a multiply by its float32 reciprocal
        s = torch.clamp(sizes.to(torch.float32), min=1.0) * float(np.float32(1.0 / self.base_size))
        one = torch.ones_like(x)
        v0 = self._sample(blurs, x, y, s, one, torch.zeros_like(x))      # unrotated
        o0 = torch.as_tensor(self._ori[:, 0], device=dev, dtype=torch.int64)
        o1 = torch.as_tensor(self._ori[:, 1], device=dev, dtype=torch.int64)
        pts = torch.as_tensor(self._pts, device=dev)
        dxy = (pts[o0] - pts[o1])[None] * s[:, None, None]                # (N, O, 2)
        norm2 = (dxy ** 2).sum(-1) + 1e-6
        g = (((v0[:, o0] - v0[:, o1]) / norm2)[..., None] * dxy).sum(1)   # (N, 2)
        ang = torch.atan2(g[:, 1], g[:, 0])
        return self._sample(blurs, x, y, s, torch.cos(ang), torch.sin(ang)), ang

    def describe(self, img: torch.Tensor, xys: torch.Tensor, sizes: torch.Tensor):
        """(N, 512) int8 bits and (N,) orientations in degrees."""
        v, ang = self.oriented_samples(img, xys, sizes)
        p0 = torch.as_tensor(self._pairs[:, 0], device=img.device, dtype=torch.int64)
        p1 = torch.as_tensor(self._pairs[:, 1], device=img.device, dtype=torch.int64)
        bits = (v[:, p0] < v[:, p1]).to(torch.int8)
        return bits, torch.remainder(torch.rad2deg(ang), 360.0)

    def compute(self, img, xys, sizes, angles=None) -> torch.Tensor:
        """(H, W) image and (N,) keypoints -> (N, 512) int8 bit-planes on
        the keypoints' device."""
        xys = torch.as_tensor(xys)
        if len(xys) == 0:
            return torch.zeros((0, 512), dtype=torch.int8, device=xys.device)
        return self.describe(image_ops.gray_image(img, xys.device), xys,
                             torch.as_tensor(sizes, device=xys.device))[0]


class BeblidDescriptor:
    """BEBLID-structure box-average comparisons via one integral image."""

    def __init__(self, bits: int = 512, seed: int = 11):
        self.boxes = beblid_boxes(bits, seed)

    def describe(self, img: torch.Tensor, xys: torch.Tensor, sizes: torch.Tensor):
        dev = img.device
        ii = image_ops.integral_image(img)
        h, w = img.shape
        flat = ii.reshape(-1)
        wi = w + 1
        boxes = torch.as_tensor(self.boxes, device=dev)

        def box_mean(cx, cy, hs):
            x1 = torch.clamp(cx - hs, 0, w - 1).to(torch.int64)
            x2 = torch.clamp(cx + hs, 1, w).to(torch.int64)
            y1 = torch.clamp(cy - hs, 0, h - 1).to(torch.int64)
            y2 = torch.clamp(cy + hs, 1, h).to(torch.int64)
            s = (flat[y2 * wi + x2] - flat[y1 * wi + x2]
                 - flat[y2 * wi + x1] + flat[y1 * wi + x1])
            area = torch.clamp((x2 - x1) * (y2 - y1), min=1)
            return s / area

        x = xys[:, 0].to(torch.float32)[:, None]
        y = xys[:, 1].to(torch.float32)[:, None]
        sc = torch.clamp(sizes.to(torch.float32), min=1.0)[:, None] * float(np.float32(1.0 / 31.0))
        a = box_mean(x + boxes[None, :, 0, 0] * sc, y + boxes[None, :, 0, 1] * sc,
                     torch.clamp(boxes[None, :, 0, 2] * sc, min=1.0))
        b = box_mean(x + boxes[None, :, 1, 0] * sc, y + boxes[None, :, 1, 1] * sc,
                     torch.clamp(boxes[None, :, 1, 2] * sc, min=1.0))
        return (a < b).to(torch.int8)

    def compute(self, img, xys, sizes, angles=None) -> torch.Tensor:
        xys = torch.as_tensor(xys)
        if len(xys) == 0:
            return torch.zeros((0, self.boxes.shape[0]), dtype=torch.int8, device=xys.device)
        return self.describe(image_ops.gray_image(img, xys.device), xys,
                             torch.as_tensor(sizes, device=xys.device))


class DescribedExtractor:
    """A detector whose descriptors a second stage replaces (``_describe``),
    on the detector's device.

    A stereo pair (``extract_stereo``) of the ORB2 detector is detected as
    one batch of two images, so a frame costs one launch of the FAST kernel,
    then each image is described and the pair is row-matched with the
    descriptors' distance (Hamming for bits, L2 for floats).  The reference
    has no fused path for these presets: it detects and describes each image
    and row-matches them with its matcher's distance
    (``Frame.compute_stereo_matches``), which gives the same keypoints,
    descriptors and matches.  Another detector extracts the two images
    apart, as the reference."""

    def __init__(self, base):
        self.base = base
        self.num_features = base.num_features
        self.device = base.device
        self.scale_factors = base.scale_factors
        self.sigma2 = base.sigma2
        self.inv_sigma2 = base.inv_sigma2

    def _describe(self, img: torch.Tensor, fd: FeatureData) -> FeatureData:
        raise NotImplementedError

    def __call__(self, img):
        fd = self.base(img)
        return self._describe(image_ops.gray_image(img, fd.xy.device), fd)

    def extract_stereo(self, img_l, img_r, bf: float, max_disp: float, max_distance: float,
                       row_tol: float):
        """Left + right detection (one batch for the ORB2 detector), each
        image described, then the row stereo match.  Returns (left
        FeatureData, ur (N,), depth (N,)), all on ``device``."""
        if isinstance(self.base, ORB2Extractor):
            imgs = self.base._upload(img_l, img_r)
            f = self.base._extract(imgs)
            fl = self._describe(imgs[0], FeatureData(*[t[0] for t in f]))
            fr = self._describe(imgs[1], FeatureData(*[t[1] for t in f]))
        else:   # another detector: each image apart, as the reference
            fl, fr = self(img_l), self(img_r)
        ur, depth = stereo_match(fl, fr, bf, max_disp, max_distance, row_tol)
        return fl, ur, depth


class BinaryDescribedExtractor(DescribedExtractor):
    """Detector + BRISK/FREAK/BEBLID descriptor replacement (reference
    presets BRISK / ORB2_FREAK / ORB2_BEBLID)."""

    def __init__(self, base, kind: str):
        super().__init__(base)
        if kind in ("BRISK", "FREAK"):
            self.descriptor = PatternBinaryDescriptor(kind)
        elif kind == "BEBLID":
            self.descriptor = BeblidDescriptor()
        else:
            raise ValueError(kind)

    def _describe(self, img: torch.Tensor, fd: FeatureData) -> FeatureData:
        des = self.descriptor.describe(img, fd.xy, fd.size)
        if isinstance(des, tuple):
            des = des[0]
        return fd._replace(desc=des)
