"""Image ops: separable Gaussian blur and the image pyramid (port of
``pyslam_tpu/ops/image.py:18-57``).

Images are float32 (..., H, W) tensors in [0, 255].

The pyramid reproduces ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples: the per-axis weight matrices of
``jax/_src/image/scale.py`` (``compute_weight_mat``: a triangle kernel
widened by 1/scale, columns normalised to sum 1, zero outside the input) are
built once per shape in numpy and applied one axis at a time.  Plain
``F.interpolate`` differs from that resize by up to 138 grey levels at level 7 of a 376x1241 image (0.0084 with
``antialias=True``), enough to move FAST corners.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """Normalised 1-D Gaussian taps (float32, computed as the reference
    does: float32 offsets, exp rounded correctly to float32, divide by the
    float32 sum; numpy's float32 exp is an ulp off at some taps)."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    arg = np.float32(-0.5) * (x / np.float32(sigma)) ** 2
    k = np.exp(arg.astype(np.float64)).astype(np.float32)
    return (k / np.sum(k, dtype=np.float32)).astype(np.float32)


def _blur_axis(img: torch.Tensor, k: list[float], dim: int) -> torch.Tensor:
    """One pass of the separable blur along ``dim`` with edge replication.

    The sum is rounded as the reference's compiled shift-and-add rounds it
    on the CPU: acc = k[1] * x[1] rounded to float32, then acc = fma(k[i],
    x[i], acc) for i = 0, 2, 3, ...  A fused multiply-add is emulated in
    float64: the product of two float32 values is exact there, and the
    float64 add and the cast back to float32 are correctly rounded on both
    devices, so the CPU and the card give the same bits."""
    radius = (len(k) - 1) // 2
    n = img.shape[dim]
    x = torch.cat([img.narrow(dim, 0, 1).expand_as(img.narrow(dim, 0, radius)), img,
                   img.narrow(dim, n - 1, 1).expand_as(img.narrow(dim, 0, radius))],
                  dim).to(torch.float64)
    acc = (x.narrow(dim, 1, n) * k[1]).to(torch.float32)
    for i in [0, *range(2, len(k))]:
        acc = torch.add(acc, x.narrow(dim, i, n), alpha=k[i]).to(torch.float32)
    return acc


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) with edge replication, rows
    then columns, with the reference's taps and rounding (``_blur_axis``)."""
    k = [float(v) for v in gaussian_kernel1d(sigma, radius)]
    return _blur_axis(_blur_axis(img, k, img.dim() - 2), k, img.dim() - 1)


@functools.lru_cache(maxsize=64)
def resize_weights(input_size: int, output_size: int) -> np.ndarray:
    """(output_size, input_size) float32 bilinear weights with antialiasing,
    as ``jax.image.resize`` builds them (scale = output / input)."""
    scale = output_size / input_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(output_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=np.float64)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    weights = np.where(inside[None, :], weights, 0.0)
    return np.ascontiguousarray(weights.T.astype(np.float32))


@functools.lru_cache(maxsize=64)
def _resize_taps(input_size: int, output_size: int):
    """The nonzero weights of ``resize_weights`` as (output_size, T) input
    indices and weights, in increasing input index (pad: weight 0)."""
    wm = resize_weights(input_size, output_size)
    nz = [np.nonzero(row)[0] for row in wm]
    t = max(1, max(len(z) for z in nz))
    idx = np.zeros((output_size, t), np.int64)
    wts = np.zeros((output_size, t), np.float32)
    for i, z in enumerate(nz):
        idx[i, :len(z)] = z
        wts[i, :len(z)] = wm[i, z]
    return idx, wts


def _resize_axis(img: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    idx_np, w_np = _resize_taps(img.shape[dim], out_size)
    idx = torch.from_numpy(idx_np).to(img.device)
    wts = torch.from_numpy(w_np).to(img.device)
    shape = [1] * img.dim()
    shape[dim] = out_size
    acc = None
    for t in range(idx.shape[1]):
        # the product of two float32 values is exact in float64; the float64
        # add and the cast back to float32 are each correctly rounded on
        # both devices, so the CPU and the card give the same bits (two
        # roundings, not a fused multiply-add)
        term = (torch.index_select(img, dim, idx[:, t]).to(torch.float64)
                * wts[:, t].reshape(shape).to(torch.float64))
        acc = (term if acc is None else term + acc).to(torch.float32)
    return acc


def resize_bilinear(img: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of (..., H, W), rows then columns.  Each
    output value is the sum of its nonzero taps in increasing input order,
    one float32 multiply and add at a time, so the CPU and the GPU give the
    same pyramid bit for bit (a matrix product sums in a device-dependent
    order and moves FAST scores and BRIEF bits at every level above 0)."""
    return _resize_axis(_resize_axis(img, new_hw[0], img.dim() - 2), new_hw[1], img.dim() - 1)


def level_shape(h: int, w: int, scale: float, lv: int) -> tuple[int, int]:
    s = scale ** lv
    return max(int(round(h / s)), 8), max(int(round(w / s)), 8)


def build_pyramid(img: torch.Tensor, num_levels: int, scale: float) -> list[torch.Tensor]:
    """List of (..., H_l, W_l) images, level l at size round(shape / scale**l)."""
    h, w = img.shape[-2:]
    out = [img]
    for lv in range(1, num_levels):
        out.append(resize_bilinear(img, level_shape(h, w, scale, lv)))
    return out
