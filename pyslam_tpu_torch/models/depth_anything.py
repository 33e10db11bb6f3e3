"""DPT-lite monocular relative depth (port of
``pyslam_tpu/models/depth_anything.py``).

A four-stage strided encoder (3x3 convolutions, flax "SAME" padding), a
decoder that upsamples the coarser map bilinearly (``jax.image.resize``'s
weights, ``layers.resize_hw``), concatenates the skip and convolves, and a
softplus head: positive relative depth at half the input resolution, then
resized to the input cropped to multiples of 16.  The convolutions carry
flax's call-order names ``Conv_0`` .. ``Conv_11``.  Without a checkpoint
(the JAX package's ``.npz``) the weights are seeded random ones
(``trained = False``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import autotuned_convs, conv_same, resize_hw, softplus

_INV_255 = float(np.float32(1.0) / np.float32(255.0))   # XLA's reciprocal of a constant divisor


class DPTLite(nn.Module):
    def __init__(self, dims: tuple = (32, 64, 128, 256)):
        super().__init__()
        self.dims = dims
        convs, cin = [], 3
        for d in dims:                                   # encoder: stride 2, then 1
            convs += [nn.Conv2d(cin, d, 3, stride=2), nn.Conv2d(d, d, 3)]
            cin = d
        for i in range(len(dims) - 2, -1, -1):           # decoder
            convs.append(nn.Conv2d(cin + dims[i], dims[i], 3))
            cin = dims[i]
        convs.append(nn.Conv2d(cin, 1, 3))
        for j, conv in enumerate(convs):
            self.add_module(f"Conv_{j}", conv)
        self.n_convs = len(convs)

    def conv(self, j: int, x):
        return conv_same(getattr(self, f"Conv_{j}"), x)

    def forward(self, x):                    # (H, W, 3) -> (H/2, W/2)
        x = x.permute(2, 0, 1)[None]
        skips, j = [], 0
        with autotuned_convs():
            for _ in self.dims:
                x = self.conv(j, x)
                x = F.relu(self.conv(j + 1, x))
                j += 2
                skips.append(x)
            y = skips[-1]
            for i in range(len(self.dims) - 2, -1, -1):
                y = resize_hw(y, skips[i].shape[-2:])
                y = F.relu(self.conv(j, torch.cat([y, skips[i]], 1)))
                j += 1
            y = self.conv(j, y)
        return softplus(y[0, 0])


class DepthAnythingInference:
    """Image -> relative depth on ``device`` (the DPT-lite estimator)."""

    def __init__(self, checkpoint: str | None = None, *, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.net = DPTLite()
        self.trained = False
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        self.net.load_state_dict(interop.dpt_lite_state_dict(interop.read_npz(path)))
        self.trained = True

    def run(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) float32 on the device -> (H16, W16) relative depth,
        the input cropped to multiples of 16."""
        h, w = img.shape[:2]
        h2, w2 = (h // 16) * 16, (w // 16) * 16
        with torch.no_grad():
            d = self.net(img[:h2, :w2] * _INV_255)
            return resize_hw(d, (h2, w2))

    def infer(self, img) -> np.ndarray:
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        d = self.run(torch.from_numpy(np.ascontiguousarray(img)).to(self.device)).cpu().numpy()
        out = np.zeros(img.shape[:2], np.float32)
        out[: d.shape[0], : d.shape[1]] = d
        return out
