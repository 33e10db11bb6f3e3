"""Small layers the learned local-feature models share, written as the JAX
package's flax code computes them (NCHW here, NHWC there).

- ``conv_same``: a convolution with flax's ``"SAME"`` padding.  For a
  stride of 2 flax pads (0, 1) where torch's ``padding=1`` pads (1, 1), so
  the pad is applied explicitly: total ``max((out - 1) * s + k - n, 0)``,
  the smaller half first.
- ``resize_hw``: bilinear resize of the last two dimensions that skips a
  dimension whose size does not change, as ``jax.image.resize`` does
  (``ops.image`` builds the antialiased weights of the JAX package).
- ``layer_norm``: flax ``LayerNorm`` (eps 1e-6, the fast variance
  ``mean(x^2) - mean(x)^2``), and ``selu`` with flax's constants.
- ``BatchNormRS``: flax ``BatchNorm(use_running_average=True)`` without
  scale or bias, ``(x - mean) * rsqrt(var + eps)``, with the running
  statistics as buffers under torch's names.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch.ops import image as image_ops


def same_pads(n: int, k: int, s: int, d: int = 1) -> tuple[int, int]:
    """(low, high) padding of flax's "SAME" along an axis of size ``n``."""
    ke = (k - 1) * d + 1
    out = -(-n // s)
    total = max((out - 1) * s + ke - n, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with ``padding=0``) applied with "SAME" padding."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    dh, dw = conv.dilation
    ph = same_pads(x.shape[-2], kh, sh, dh)
    pw = same_pads(x.shape[-1], kw, sw, dw)
    return conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


def resize_hw(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear (antialiased when it shrinks) resize of (..., H, W) to
    ``hw``; an axis whose size stays is left alone."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    if h == hw[0]:
        return image_ops._resize_axis(x, hw[1], x.dim() - 1)
    if w == hw[1]:
        return image_ops._resize_axis(x, hw[0], x.dim() - 2, image_ops.depth_panel(h))
    return image_ops.resize_bilinear(x, hw)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm`` over the last axis with ``ln``'s weight and bias."""
    mu = x.mean(-1, keepdim=True)
    mu2 = (x * x).mean(-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    return (x - mu) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def selu(x: torch.Tensor) -> torch.Tensor:
    """flax ``selu``: scale * where(x > 0, x, alpha * expm1(x))."""
    return _SELU_SCALE * torch.where(x > 0, x, _SELU_ALPHA * torch.expm1(x))


class BatchNormRS(nn.Module):
    """flax inference BatchNorm without scale or bias (XFeat's)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        m = self.running_mean.view(1, -1, 1, 1)
        v = self.running_var.view(1, -1, 1, 1)
        return (x - m) * torch.rsqrt(v + self.eps)


def rgb_image(img, device) -> torch.Tensor:
    """A grey (H, W) or colour (H, W, 3) image, numpy or tensor -> (H, W, 3)
    float32 on ``device`` (grey repeated on the three channels)."""
    t = img if isinstance(img, torch.Tensor) else torch.as_tensor(np.asarray(img, np.float32))
    t = t.to(device=device, dtype=torch.float32)
    return t if t.dim() == 3 else t[..., None].expand(*t.shape, 3)


def truncation_resample(img: np.ndarray, hw) -> np.ndarray:
    """(H, W[, C]) host image -> (h, w[, C]) by nearest sampling at
    ``floor(i * H / h)`` (the host resampling the JAX package's dense
    matchers and VPR networks apply before their fixed-size network)."""
    h, w = hw
    ys = np.clip((np.arange(h) * img.shape[0] / h).astype(int), 0, img.shape[0] - 1)
    xs = np.clip((np.arange(w) * img.shape[1] / w).astype(int), 0, img.shape[1] - 1)
    return img[np.ix_(ys, xs)]


_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
_IMAGENET_STD = np.array([0.229, 0.224, 0.225])


def imagenet_square(img, px: int) -> np.ndarray:
    """The MegaLoc / AlexNet host pre-processing: grey -> 3 channels, a
    ``px`` square by ``truncation_resample``, /255 when 8-bit valued,
    ImageNet normalisation in float64, then float32."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    x = truncation_resample(img, (px, px))
    if x.max() > 2.0:
        x = x / 255.0
    return np.ascontiguousarray((x - _IMAGENET_MEAN) / _IMAGENET_STD, np.float32)


def l2_normalize(d: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    """d / max(|d|, eps) along ``dim``."""
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=dim, keepdim=True), min=eps)


def single_level(ex, num_features: int, device, trained: bool = False):
    """The one-level pyramid attributes of a learned extractor."""
    ex.num_features = num_features
    ex.device = torch.device(device)
    ex.trained = trained
    ex.scale_factors = np.array([1.0], np.float32)
    ex.sigma2 = np.array([1.0], np.float32)
    ex.inv_sigma2 = 1.0 / ex.sigma2


def feature_data(xy, resp, valid, desc, size=8.0, angle=None):
    """FeatureData of a one-level extractor: level 0, ``size`` (a number
    or a tensor), ``angle`` (None: 0)."""
    from pyslam_tpu_torch.features.orb2 import FeatureData

    n, dev = xy.shape[0], xy.device
    if not isinstance(size, torch.Tensor):
        size = torch.full((n,), float(size), dtype=torch.float32, device=dev)
    if angle is None:
        angle = torch.zeros(n, dtype=torch.float32, device=dev)
    return FeatureData(xy=xy, level=torch.zeros(n, dtype=torch.int64, device=dev),
                       angle=angle, size=size, response=resp, desc=desc.contiguous(),
                       valid=valid)
