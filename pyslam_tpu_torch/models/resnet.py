"""torchvision-layout ResNet trunk in inference mode (port of
``pyslam_tpu/models/resnet.py``).

The backbone of CosPlace / EigenPlaces (``models/cosplace.py``).  Module
names, block structure and the state-dict layout are torchvision's
(``conv1``, ``bn1``, ``layer{1-4}.{b}.conv{1-3}`` / ``bn{1-3}`` /
``downsample.{0,1}``), so a torchvision checkpoint loads key for key
(``torch_convert.resnet_from_torch`` drops only the head).  Batch norm is
the inference form with the running statistics as buffers;
``trainable_statistics_`` turns them into parameters for training, as the
JAX package holds them (its ``BN`` keeps all four tensors as params, so
its CosPlace trainer's Adam steps the statistics with the weights).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BN(nn.Module):
    """Inference batch norm: (x - mean) / sqrt(var + eps) * weight + bias,
    over the channels of an NCHW tensor (the JAX package's formula)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        def c(v):
            return v.view(1, -1, 1, 1)

        return ((x - c(self.running_mean)) / torch.sqrt(c(self.running_var) + self.eps)
                * c(self.weight) + c(self.bias))


def trainable_statistics_(module: nn.Module) -> nn.Module:
    """Turn the running statistics of every ``BN`` in ``module`` into
    parameters (same names, same values, so the state dict keeps its keys);
    the forward stays the inference form, with no batch statistics."""
    for m in module.modules():
        if isinstance(m, BN):
            for name in ("running_mean", "running_var"):
                value = m._buffers.pop(name)
                m.register_parameter(name, nn.Parameter(value))
    return module


def _downsample(inplanes: int, out_ch: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(inplanes, out_ch, 1, stride=stride, bias=False), BN(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        d = dilation
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=d, dilation=d,
                               bias=False)
        self.bn1 = BN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=d, dilation=d, bias=False)
        self.bn2 = BN(planes)
        self.downsample = _downsample(inplanes, planes, stride) if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idn)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        d = dilation
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=d, dilation=d,
                               bias=False)
        self.bn2 = BN(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = BN(out_ch)
        self.downsample = _downsample(inplanes, out_ch, stride) if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idn)


_CONFIGS = {
    "resnet9": (BasicBlock, (1, 1, 1, 1)),   # the tiny bundled nets
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """Feature trunk without avgpool / fc, NCHW in and out.

    ``dilate`` is torchvision's ``replace_stride_with_dilation`` for
    (layer2, layer3, layer4); ``width`` the stem width (stages w, 2w, 4w,
    8w; 64 is torchvision's, which converted checkpoints need)."""

    def __init__(self, arch: str = "resnet50", dilate: Sequence[bool] = (False, False, False),
                 width: int = 64):
        super().__init__()
        block, counts = _CONFIGS[arch]
        self.arch = arch
        w0 = width
        self.conv1 = nn.Conv2d(3, w0, 7, stride=2, padding=3, bias=False)
        self.bn1 = BN(w0)
        in_ch = w0
        dilation = 1
        for li, (planes, n) in enumerate(zip((w0, 2 * w0, 4 * w0, 8 * w0), counts)):
            stride = 1 if li == 0 else 2
            prev_dilation = dilation   # torchvision: the first block keeps the
            if li > 0 and dilate[li - 1]:   # dilation from before the replacement
                dilation *= stride
                stride = 1
            blocks = []
            for bi in range(n):
                s = stride if bi == 0 else 1
                need_ds = bi == 0 and (s != 1 or in_ch != planes * block.expansion)
                blocks.append(block(in_ch, planes, stride=s,
                                    dilation=prev_dilation if bi == 0 else dilation,
                                    downsample=need_ds))
                in_ch = planes * block.expansion
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        self.out_channels = in_ch

    def forward(self, x, return_taps: bool = False):
        """(B, 3, H, W) -> the layer4 map; with ``return_taps`` also a dict
        of every stage's output."""
        x = F.relu(self.bn1(self.conv1(x)))
        # the reference pads with -inf before a VALID 3x3/2 pool: torch's
        # max pool pads with -inf
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        taps = {}
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            taps[f"layer{li}"] = x
        if return_taps:
            return x, taps
        return x
