"""NetVLAD place recognition: VGG16 up to conv5_3 and NetVLAD pooling (port
of ``pyslam_tpu/models/netvlad.py``).

``encoder`` is torchvision's VGG16 ``features`` without its last pool
(13 convolutions with ReLU, max pools after conv1_2, conv2_2, conv3_3 and
conv4_3), ``pool`` the pytorch-NetVlad layer: the soft assignment as a 1x1
convolution without bias (``pool.conv``) over L2-normalised descriptors,
the residual sums to ``pool.centroids``, intra-normalisation, then a global
L2.  The names are the standard pytorch-NetVlad checkpoint's, so one loads
key for key (``torch_convert.netvlad_from_torch_file``).  Input: ImageNet
normalisation of a [0, 1] image resampled on the host to ``input_hw`` by
integer truncation (the reference's host code).  Without a checkpoint the
weights are seeded random ones (``trained = False``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import truncation_resample

# torchvision VGG16 .features: 13 convolutions, a pool after these
VGG16_CONV_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
_POOL_AFTER = {1, 3, 6, 9}          # NetVLAD crops VGG16 at conv5_3 (no final pool)
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def vgg16_conv5() -> nn.Sequential:
    """torchvision ``vgg16().features[:-1]`` (the indices of its state dict)."""
    layers, cin = [], 3
    for i, c in enumerate(VGG16_CONV_CHANNELS):
        layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
        if i in _POOL_AFTER:
            layers.append(nn.MaxPool2d(2, 2))
        cin = c
    return nn.Sequential(*layers)


class NetVLADLayer(nn.Module):
    def __init__(self, num_clusters: int = 64, dim: int = 512):
        super().__init__()
        self.conv = nn.Conv2d(dim, num_clusters, 1, bias=False)
        self.centroids = nn.Parameter(torch.randn(num_clusters, dim))

    def forward(self, feats):                # (B, D, H, W) -> (B, K * D)
        x = feats.flatten(2).transpose(1, 2)                   # (B, HW, D)
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        a = torch.softmax(x @ self.conv.weight[:, :, 0, 0].T, -1)            # (B, HW, K)
        sums = torch.einsum("bnk,bnd->bkd", a, x)
        vlad = sums - a.sum(1)[..., None] * self.centroids[None]
        vlad = vlad / torch.clamp(torch.linalg.vector_norm(vlad, dim=-1, keepdim=True),
                                  min=1e-12)
        v = vlad.flatten(1)
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


class NetVLADNet(nn.Module):
    def __init__(self, num_clusters: int = 64):
        super().__init__()
        self.encoder = vgg16_conv5()
        self.pool = NetVLADLayer(num_clusters, 512)
        self.register_buffer("mean", torch.from_numpy(_IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.from_numpy(_IMAGENET_STD), persistent=False)

    def forward(self, img):                  # (B, H, W, 3) in [0, 1]
        x = ((img - self.mean) / self.std).permute(0, 3, 1, 2)
        return self.pool(self.encoder(x))


class NetVLADExtractor:
    """Image -> (K * 512,) global descriptor (host array), computed on
    ``device``."""

    def __init__(self, num_clusters: int = 64, checkpoint: str | None = None,
                 input_hw=(240, 320), *, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.input_hw = input_hw
        self.net = NetVLADNet(num_clusters)
        self.trained = False
        if checkpoint:
            if str(checkpoint).endswith((".pth", ".pt")):
                from pyslam_tpu_torch.models.torch_convert import netvlad_from_torch_file

                sd = netvlad_from_torch_file(checkpoint)
            else:
                sd = interop.netvlad_state_dict(interop.read_npz(checkpoint))
            self.net.load_state_dict(sd)
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def prepare(self, img) -> np.ndarray:
        """(H, W) grey or (H, W, 3) RGB in [0, 255] -> (h, w, 3) in [0, 1]
        at ``input_hw`` (nearest, by integer truncation)."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        return np.ascontiguousarray(truncation_resample(img, self.input_hw) / 255.0, np.float32)

    def describe(self, x: torch.Tensor) -> torch.Tensor:
        """(h, w, 3) prepared image on the device -> descriptor on it."""
        with torch.no_grad():
            return self.net(x[None])[0]

    def __call__(self, img) -> np.ndarray:
        return self.describe(torch.from_numpy(self.prepare(img)).to(self.device)).cpu().numpy()
