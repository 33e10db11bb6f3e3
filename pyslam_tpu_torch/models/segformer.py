"""SegFormer-class semantic segmentation (port of
``pyslam_tpu/models/segformer.py``).

A MiT-B0-style hierarchical encoder of four stages (dims 32/64/160/256,
strides 4/2/2/2: a 3x3 convolution with flax's "SAME" padding, LayerNorm,
two residual MixFFNs with the tanh GELU), then the MLP decode head: each
stage projected to 128 channels and resized bilinearly to the first
stage's 1/4 grid (``jax.image.resize``'s weights), concatenated, fused,
and classified.  ``SegFormerInference`` crops the image to multiples of 4,
upsamples the logits to the crop bilinearly and fills the rest with label
0 and zero probabilities, as the reference does.

The modules carry flax's call-order names (``SegFormerEncoderStage_i``
with ``Conv_0``, ``LayerNorm_0``, ``MixFFN_0/1``; the head's ``Dense_0-5``).
``load_checkpoint`` reads the JAX package's ``.npz`` (its values in the
sorted order of the file's keys, matched to the flax tree's leaves,
``interop.segformer_npz_state_dict``).  Without a checkpoint the weights
are seeded random ones (``trained = False``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import conv_same, layer_norm, resize_hw

DIMS = (32, 64, 160, 256)
HEAD_DIM = 128


class MixFFN(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, 4 * dim)
        self.Dense_1 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return x + self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class SegFormerEncoderStage(nn.Module):
    def __init__(self, in_ch: int, dim: int, stride: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, dim, 3, stride=stride)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.MixFFN_0 = MixFFN(dim)
        self.MixFFN_1 = MixFFN(dim)

    def forward(self, x):                    # (1, C, H, W) -> (1, dim, h, w)
        y = conv_same(self.Conv_0, x).permute(0, 2, 3, 1)
        y = self.MixFFN_1(self.MixFFN_0(layer_norm(self.LayerNorm_0, y)))
        return y.permute(0, 3, 1, 2)


class SegFormerNet(nn.Module):
    def __init__(self, num_classes: int = 19, dims=DIMS):
        super().__init__()
        in_ch = 3
        for i, d in enumerate(dims):
            self.add_module(f"SegFormerEncoderStage_{i}",
                            SegFormerEncoderStage(in_ch, d, 4 if i == 0 else 2))
            in_ch = d
        self.n_stages = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"Dense_{i}", nn.Linear(d, HEAD_DIM))
        n = len(dims)
        self.add_module(f"Dense_{n}", nn.Linear(n * HEAD_DIM, HEAD_DIM))
        self.add_module(f"Dense_{n + 1}", nn.Linear(HEAD_DIM, num_classes))

    def forward(self, x):                    # (H, W, 3) -> (K, H/4, W/4)
        n = self.n_stages
        x = x.permute(2, 0, 1)[None]
        feats = []
        for i in range(n):
            x = getattr(self, f"SegFormerEncoderStage_{i}")(x)
            feats.append(x)
        hw4 = tuple(feats[0].shape[-2:])
        ups = []
        for i, f in enumerate(feats):
            p = getattr(self, f"Dense_{i}")(f.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            ups.append(resize_hw(p, hw4))
        y = torch.cat(ups, 1).permute(0, 2, 3, 1)
        y = F.relu(getattr(self, f"Dense_{n}")(y))
        return getattr(self, f"Dense_{n + 1}")(y)[0].permute(2, 0, 1)


class SegFormerInference:
    """Image -> ``{"labels", "probs"}`` host arrays, the network on
    ``device``."""

    def __init__(self, num_classes: int = 19, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.num_classes = num_classes
        self.device = torch.device(device)
        self.net = SegFormerNet(num_classes=num_classes)
        self.trained = False
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        self.net.load_state_dict(interop.segformer_npz_state_dict(path, self.net))
        self.trained = True

    def logits(self, img) -> torch.Tensor:
        """(H, W[, 3]) image -> (K, H4, W4) logits on the device at the
        crop to multiples of 4 (the image /255)."""
        x = np.asarray(img, np.float32)
        if x.ndim == 2:
            x = np.stack([x] * 3, -1)
        h4, w4 = (x.shape[0] // 4) * 4, (x.shape[1] // 4) * 4
        with torch.no_grad():
            t = torch.from_numpy(np.ascontiguousarray(x[:h4, :w4])).to(self.device) / 255.0
            return resize_hw(self.net(t), (h4, w4))

    def infer(self, img) -> dict:
        h, w = np.asarray(img).shape[:2]
        logits = self.logits(img)
        lh, lw = logits.shape[-2:]
        lab = np.zeros((h, w), np.int32)
        pr = np.zeros((h, w, self.num_classes), np.float32)
        lab[:lh, :lw] = torch.argmax(logits, 0).to(torch.int32).cpu().numpy()
        pr[:lh, :lw] = torch.softmax(logits, 0).permute(1, 2, 0).cpu().numpy()
        return {"labels": lab, "probs": pr}
