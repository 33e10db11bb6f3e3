"""FAST-9 corner score and strict 3x3 NMS (port of ``pyslam_tpu/ops/fast.py``
and of the fused Pallas kernel ``pyslam_tpu/ops/pallas_fast.py``).

``fast_nms_pyramid`` is the entry point the extractor calls, once a frame
for every level of the pyramid; ``fast_nms`` is its one-level case.  On
CUDA tensors both launch the hand-written kernel ``csrc/fast_nms.cu`` (built
at first use), once a call, or raise; on CPU tensors they run the plain
PyTorch version ``nms3x3(fast_score_map(...))`` beside it, which is also
what the kernel is checked against.  ``fast_nms.launches`` counts the
kernel's launches from either entry point, under a lock (sessions in several
threads share the count).
"""

from __future__ import annotations

import threading

import torch

MAX_LEVELS = 16   # levels the kernel's table holds (csrc/fast_nms.cu)
_count_lock = threading.Lock()   # sessions in several threads bump one count

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


def fast_nms_pyramid(levels: list[torch.Tensor], threshold: float,
                     border: int = 16) -> list[torch.Tensor]:
    """FAST-9 score + strict 3x3 NMS of every level of a pyramid: a list of
    (B, H_l, W_l) float32 batches -> the list of their score maps.

    CUDA tensors (all on one card, one batch size, at most
    ``MAX_LEVELS``) go through one launch of the kernel for all levels;
    CPU tensors through the plain version level by level.  Anything else
    raises."""
    if not levels:
        raise ValueError("fast_nms_pyramid: no levels")
    if all(x.device.type == "cpu" for x in levels):
        return [fast_nms_plain(x, threshold, border) for x in levels]
    for x in levels:
        if x.device.type != "cuda":
            raise ValueError(f"fast_nms_pyramid: unsupported device {x.device}")
        if x.dtype != torch.float32 or x.dim() != 3:
            raise ValueError(f"fast_nms_pyramid: expected (B, H, W) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("fast_nms_pyramid: input must be contiguous")
        if 0 in x.shape:
            raise ValueError(f"fast_nms_pyramid: empty batch {tuple(x.shape)}")
    if border < 4:
        raise ValueError("fast_nms_pyramid: the kernel needs border >= 4")
    if len({x.device for x in levels}) != 1 or len({x.shape[0] for x in levels}) != 1:
        raise ValueError("fast_nms_pyramid: levels must share a device and a batch size")
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"fast_nms_pyramid: at most {MAX_LEVELS} levels")
    import ctypes

    from pyslam_tpu_torch import _build

    lib = _build.load()
    n = len(levels)
    outs = [torch.empty_like(x) for x in levels]
    ins_p = (ctypes.c_void_p * n)(*[x.data_ptr() for x in levels])
    outs_p = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    hs = (ctypes.c_int * n)(*[x.shape[1] for x in levels])
    ws = (ctypes.c_int * n)(*[x.shape[2] for x in levels])
    dev = levels[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pyslam_fast_nms_pyramid(ins_p, outs_p, hs, ws, n, levels[0].shape[0],
                                          float(threshold), int(border), stream)
    if err != 0:
        raise RuntimeError(f"fast_nms_pyramid kernel launch failed: cudaError {err}")
    with _count_lock:
        fast_nms.launches += 1
    return outs


def fast_nms(imgs: torch.Tensor, threshold: float,
             border: int = 16) -> torch.Tensor:
    """FAST-9 score + strict 3x3 NMS of a (B, H, W) float32 batch: the
    one-level case of ``fast_nms_pyramid`` (one launch on the card, the
    plain version on the CPU)."""
    return fast_nms_pyramid([imgs], threshold, border)[0]


fast_nms.launches = 0
