"""Device identity and placement for the port's entry points."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def same_device(a: torch.device | str, b: torch.device | str) -> bool:
    """True when ``a`` and ``b`` name the same device; a CUDA device without
    an index matches any index (``"cuda"`` and ``"cuda:0"``)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``: a host array is uploaded, a
    tensor already on a device of that type is kept there, and a tensor on
    another device is refused (nothing moves between devices silently)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != torch.device(device).type:
            raise ValueError(f"tensor on {x.device}, expected {device}")
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms for the block (the
    trainers: the same seed gives the same checkpoint on the same card),
    then the previous setting again."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
