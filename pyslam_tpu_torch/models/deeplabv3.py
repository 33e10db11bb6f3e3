"""DeepLabv3 (ResNet, output stride 8) semantic segmentation (port of
``pyslam_tpu/models/deeplabv3.py``).

torchvision's ``segmentation/deeplabv3.py`` layout: the ported ``ResNet``
with ``replace_stride_with_dilation=(False, True, True)`` as the backbone,
then the DeepLab head:

    ASPP(2048 -> 256, atrous rates 12/24/36): a 1x1 conv+BN+ReLU, three
      3x3 dilated conv+BN+ReLU, the image-pooling branch (global mean,
      1x1 conv+BN+ReLU, broadcast), a 1x1 projection (5*256 -> 256)+BN+ReLU;
    a 3x3 conv 256->256 + BN + ReLU, a 1x1 conv 256 -> num_classes;
    the logits resized bilinearly to the input (``jax.image.resize``'s
    weights, ``layers.resize_hw``).

The modules carry the JAX package's names (``backbone``, ``aspp.conv0-3``,
``aspp.pool_conv``, ``aspp.project``, ``head``, ``out``), the backbone
torchvision's; ``torch_convert.deeplabv3_from_torch`` maps an official
``deeplabv3_resnet50`` checkpoint (its ``aux_classifier`` dropped).  Without
a checkpoint the weights are seeded random ones (``trained = False``).
The convolutions run under cuDNN's autotuned algorithms.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import autotuned_convs, resize_hw
from pyslam_tpu_torch.models.resnet import BN, ResNet

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class _ConvBNReLU(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 1, dilation: int = 1):
        super().__init__()
        pad = dilation * (kernel - 1) // 2
        self.conv = nn.Conv2d(in_ch, features, kernel, padding=pad, dilation=dilation,
                              bias=False)
        self.bn = BN(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ASPP(nn.Module):
    def __init__(self, in_ch: int, features: int = 256, rates=(12, 24, 36)):
        super().__init__()
        self.rates = tuple(rates)
        self.conv0 = _ConvBNReLU(in_ch, features, 1)
        for i, r in enumerate(self.rates):
            self.add_module(f"conv{i + 1}", _ConvBNReLU(in_ch, features, 3, dilation=r))
        self.pool_conv = _ConvBNReLU(in_ch, features, 1)
        self.project = _ConvBNReLU(features * (len(self.rates) + 2), features, 1)

    def forward(self, x):
        outs = [self.conv0(x)]
        for i in range(len(self.rates)):
            outs.append(getattr(self, f"conv{i + 1}")(x))
        g = self.pool_conv(x.mean(dim=(2, 3), keepdim=True))
        outs.append(g.expand_as(outs[0]))
        return self.project(torch.cat(outs, 1))


class DeepLabV3(nn.Module):
    def __init__(self, num_classes: int = 21, arch: str = "resnet50"):
        super().__init__()
        self.backbone = ResNet(arch=arch, dilate=(False, True, True))
        self.aspp = ASPP(self.backbone.out_channels)
        self.head = _ConvBNReLU(256, 256, 3)
        self.out = nn.Conv2d(256, num_classes, 1)

    def forward(self, x):                    # (B, 3, H, W) ImageNet-normalised
        with autotuned_convs():
            y = self.out(self.head(self.aspp(self.backbone(x))))
        return resize_hw(y, tuple(x.shape[-2:]))


class DeepLabV3Segmenter:
    """Segmentation backend: ``infer(img) -> {"labels", "probs"}`` (host
    arrays at the input size), the network on ``device``."""

    def __init__(self, num_classes: int = 21, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.num_classes = num_classes
        self.device = torch.device(device)
        self.net = DeepLabV3(num_classes=num_classes)
        self.trained = False
        if checkpoint:
            from pyslam_tpu_torch.models.torch_convert import deeplabv3_from_torch, load_torch_file

            self.net.load_state_dict(deeplabv3_from_torch(load_torch_file(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def prepare(self, img) -> np.ndarray:
        """Host pre-processing: grey -> 3 channels, /255 when 8-bit valued,
        ImageNet normalisation, zero padding to multiples of 8."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img / 255.0 if img.max() > 2.0 else img
        img = (img - _IMAGENET_MEAN) / _IMAGENET_STD
        h, w = img.shape[:2]
        canvas = np.zeros((((h + 7) // 8) * 8, ((w + 7) // 8) * 8, 3), np.float32)
        canvas[:h, :w] = img
        return canvas

    def logits(self, x: np.ndarray) -> torch.Tensor:
        """(H, W, 3) prepared canvas -> (num_classes, H, W) logits on the
        device."""
        with torch.no_grad():
            t = torch.from_numpy(x).to(self.device).permute(2, 0, 1)[None]
            return self.net(t)[0]

    def infer(self, img) -> dict:
        h, w = np.asarray(img).shape[:2]
        logits = self.logits(self.prepare(img))
        labels = torch.argmax(logits, 0).to(torch.int32)
        probs = torch.softmax(logits, 0).permute(1, 2, 0)
        return {"labels": labels.cpu().numpy()[:h, :w],
                "probs": probs.cpu().numpy()[:h, :w]}
