"""FAST-9 corner score and strict 3x3 NMS (port of ``pyslam_tpu/ops/fast.py``
and of the fused Pallas kernel ``pyslam_tpu/ops/pallas_fast.py``).

``fast_nms`` is the one entry point the extractor calls.  On a CUDA tensor
it launches the hand-written kernel ``csrc/fast_nms.cu`` (built at first
use) or raises; on a CPU tensor it runs the plain PyTorch version
``nms3x3(fast_score_map(...))`` beside it, which is also what the kernel is
checked against.
"""

from __future__ import annotations

import torch

# Bresenham circle of radius 3, clockwise from the top: (dy, dx) pairs.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _run9_min(diff: torch.Tensor) -> torch.Tensor:
    """diff: (16, ...) -> per-start min over the circular 9-window (dim 0)."""
    m = diff
    r2 = torch.minimum(m, torch.roll(m, -1, 0))
    r4 = torch.minimum(r2, torch.roll(r2, -2, 0))
    r8 = torch.minimum(r4, torch.roll(r4, -4, 0))
    return torch.minimum(r8, torch.roll(m, -8, 0))


def fast_score_map(img: torch.Tensor, threshold: float,
                   border: int = 16) -> torch.Tensor:
    """FAST-9 score for every pixel of (..., H, W) images (0 where not a
    corner): the larger of the bright and dark "max over 9-windows of the
    min difference", thresholded, with a zeroed border."""
    nb = torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(-2, -1)) for dy, dx in CIRCLE], 0)
    sb = torch.amax(_run9_min(nb - img[None]), 0)
    sd = torch.amax(_run9_min(img[None] - nb), 0)
    score = torch.maximum(sb, sd)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    score = torch.where(score > threshold, score, zero)
    h, w = img.shape[-2:]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (
        xs < w - border)
    return torch.where(inside, score, zero)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Zero every pixel of (..., H, W) that is not the strict maximum of its
    3x3 window (outside the image counts as -inf)."""
    h, w = score.shape[-2:]
    p = torch.nn.functional.pad(score, (1, 1, 1, 1), value=float("-inf"))
    neigh = torch.stack(
        [p[..., dy:dy + h, dx:dx + w]
         for dy in range(3) for dx in range(3) if not (dy == 1 and dx == 1)],
        0)
    is_max = score > torch.amax(neigh, 0)
    return torch.where(is_max, score, torch.zeros((), dtype=score.dtype,
                                                  device=score.device))


def fast_nms_plain(imgs: torch.Tensor, threshold: float,
                   border: int = 16) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, H, W) -> (B, H, W)."""
    return nms3x3(fast_score_map(imgs, threshold, border))


def fast_nms(imgs: torch.Tensor, threshold: float,
             border: int = 16) -> torch.Tensor:
    """FAST-9 score + strict 3x3 NMS of a (B, H, W) float32 batch.

    A CUDA tensor goes through the hand-written kernel (one launch for the
    whole batch, counted in ``fast_nms.launches``); a CPU tensor through the
    plain version.  Any other device, or a tensor the kernel does not take,
    raises.
    """
    if imgs.device.type == "cpu":
        return fast_nms_plain(imgs, threshold, border)
    if imgs.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {imgs.device}")
    if imgs.dtype != torch.float32 or imgs.dim() != 3:
        raise ValueError(
            f"fast_nms: expected (B, H, W) float32, got {tuple(imgs.shape)} "
            f"{imgs.dtype}")
    if not imgs.is_contiguous():
        raise ValueError("fast_nms: input must be contiguous")
    b, h, w = imgs.shape
    if b == 0 or h == 0 or w == 0:
        raise ValueError(f"fast_nms: empty batch {tuple(imgs.shape)}")
    if border < 4:
        raise ValueError("fast_nms: the kernel needs border >= 4")
    from pyslam_tpu_torch import _build

    lib = _build.load()
    out = torch.empty_like(imgs)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        err = lib.pyslam_fast_nms(imgs.data_ptr(), out.data_ptr(), b, h, w,
                                  float(threshold), int(border), stream)
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError {err}")
    fast_nms.launches += 1
    return out


fast_nms.launches = 0
