"""Patch-descriptor networks over oriented 32x32 keypoint patches (port of
``pyslam_tpu/models/patch_descriptors.py``): HardNet, L2Net, SOSNet,
TFeat, GeoDesc (with ``return_inter``, the conv5 map ContextDesc reads) and
the log-polar descriptor.

The modules keep the official torch layouts: the L2Net-class backbone is
the ``features`` Sequential of HardNet's repository (conv, BN, ReLU per
layer, a Dropout before the 8x8 conv, so the convolutions sit at indices
0, 3, 6, 9, 12, 15, 19), TFeat is ``features`` (InstanceNorm, conv7,
tanh, pool, conv6, tanh) + ``classifier`` (linear, tanh).  GeoDesc comes
from TF1 and has no torch layout: its modules carry the JAX package's
names.  Normalisations follow the reference: HardNet's input norm uses the
unbiased std plus 1e-7, the instance norm the biased variance with eps
1e-5 inside the root, batch norm the running statistics.

``PatchDescriptorExtractor.compute`` samples every keypoint's patch in one
batched gather (``ops.patches``) and runs the network once over the batch,
on the keypoints' device.
"""

from __future__ import annotations

import torch
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import torch_convert
from pyslam_tpu_torch.models.layers import conv_same
from pyslam_tpu_torch.ops.patches import extract_log_polar_patches, extract_oriented_patches


def _input_norm_unbiased(x: torch.Tensor) -> torch.Tensor:
    """HardNet.input_norm: per patch (x - mean) / (std + 1e-7), unbiased."""
    flat = x.reshape(x.shape[0], -1)
    mean = flat.mean(1)
    var = ((flat - mean[:, None]) ** 2).sum(1) / (flat.shape[1] - 1)
    std = torch.sqrt(var) + 1e-7
    return (x - mean.view(-1, 1, 1, 1)) / std.view(-1, 1, 1, 1)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) of one-channel patches: biased."""
    flat = x.reshape(x.shape[0], -1)
    mean = flat.mean(1)
    var = ((flat - mean[:, None]) ** 2).mean(1)
    return (x - mean.view(-1, 1, 1, 1)) / torch.sqrt(var + eps).view(-1, 1, 1, 1)


def _l2_unit(d: torch.Tensor) -> torch.Tensor:
    return d / torch.sqrt((d * d).sum(1, keepdim=True) + 1e-10)


class BN(nn.Module):
    """Inference batch norm with running statistics:
    (x - mean) / sqrt(var + eps), then * weight + bias when affine."""

    def __init__(self, features: int, affine: bool = False, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        def c(v):
            return v.view(1, -1, 1, 1)

        y = (x - c(self.running_mean)) / torch.sqrt(c(self.running_var) + self.eps)
        return y if self.weight is None else y * c(self.weight) + c(self.bias)


_BACKBONE = [  # (out_ch, kernel, stride, padding)
    (32, 3, 1, 1), (32, 3, 1, 1), (64, 3, 2, 1), (64, 3, 1, 1),
    (128, 3, 2, 1), (128, 3, 1, 1), (128, 8, 1, 0)]


def _backbone(bias: bool, affine: bool, eps: float) -> nn.Sequential:
    layers, cin = [], 1
    for i, (ch, k, s, p) in enumerate(_BACKBONE):
        if i == len(_BACKBONE) - 1:
            layers.append(nn.Identity())           # the Dropout (inference)
        layers += [nn.Conv2d(cin, ch, k, stride=s, padding=p, bias=bias),
                   BN(ch, affine=affine, eps=eps)]
        if i < len(_BACKBONE) - 1:
            layers.append(nn.ReLU())
        cin = ch
    return nn.Sequential(*layers)


class HardNet(nn.Module):
    """input_norm -> backbone -> L2 (feature_hardnet.py:64)."""

    def __init__(self):
        super().__init__()
        self.features = _backbone(bias=False, affine=False, eps=1e-5)

    def forward(self, patches):                    # (N, 32, 32)
        x = _input_norm_unbiased(patches[:, None])
        return _l2_unit(self.features(x).flatten(1))


class L2Net(nn.Module):
    """L2Net as in the reference wrapper: biased convs, affine BN eps 1e-10."""

    def __init__(self):
        super().__init__()
        self.features = _backbone(bias=True, affine=True, eps=1e-10)

    def forward(self, patches):
        x = _input_norm_unbiased(patches[:, None])
        return _l2_unit(self.features(x).flatten(1))


class SOSNet(nn.Module):
    """SOSNet 32x32: instance norm input, HardNet backbone, L2."""

    def __init__(self):
        super().__init__()
        self.features = _backbone(bias=False, affine=False, eps=1e-5)

    def forward(self, patches):
        x = _instance_norm(patches[:, None])
        return _l2_unit(self.features(x).flatten(1))


class LogPolarDesc(HardNet):
    """The log-polar descriptor: HardNet's tower over log-polar patches."""


class TFeat(nn.Module):
    """TFeat TNet: instance norm, conv7 tanh pool conv6 tanh, fc tanh (not
    L2-normalised)."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(nn.Identity(), nn.Conv2d(1, 32, 7), nn.Tanh(),
                                      nn.MaxPool2d(2), nn.Conv2d(32, 64, 6), nn.Tanh())
        self.classifier = nn.Sequential(nn.Linear(64 * 8 * 8, 128), nn.Tanh())

    def forward(self, patches):
        x = self.features(_instance_norm(patches[:, None]))
        return self.classifier(x.flatten(1))


class GeoDesc(nn.Module):
    """GeoDesc tower: instance norm, 6 x (conv3x3 SAME, affine BN, ReLU)
    with strides (1, 1, 2, 1, 2, 1), a bias-free 8x8 conv to 128, L2."""

    CHANS = ((32, 1), (32, 1), (64, 2), (64, 1), (128, 2), (128, 1))

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (ch, s) in enumerate(self.CHANS):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3, stride=s, bias=False))
            self.add_module(f"bn{i}", BN(ch, affine=True, eps=1e-5))
            cin = ch
        self.conv6 = nn.Conv2d(128, 128, 8, bias=False)

    def forward(self, patches, return_inter: bool = False):
        x = _instance_norm(patches[:, None])
        for i in range(len(self.CHANS)):
            x = torch.relu(getattr(self, f"bn{i}")(conv_same(getattr(self, f"conv{i}"), x)))
        inter = x                                    # conv5: (N, 128, 8, 8)
        d = _l2_unit(self.conv6(x).flatten(1))
        return (d, inter) if return_inter else d


# name -> (module, JAX-tree converter, official-layout converter,
#          magnification, sampler)
PATCH_DESCRIPTOR_REGISTRY = {
    "HARDNET": (HardNet, interop.hardnet_state_dict, torch_convert.hardnet_from_torch, 1.0,
                "cartesian"),
    "SOSNET": (SOSNet, interop.hardnet_state_dict, torch_convert.sosnet_from_torch, 3.0,
               "cartesian"),
    "L2NET": (L2Net, interop.hardnet_state_dict, torch_convert.hardnet_from_torch, 1.0,
              "cartesian"),
    "TFEAT": (TFeat, interop.tfeat_state_dict, torch_convert.tfeat_from_torch, 3.0,
              "cartesian"),
    "GEODESC": (GeoDesc, interop.same_names_state_dict, None, 3.0, "cartesian"),
    "LOGPOLAR": (LogPolarDesc, interop.hardnet_state_dict, torch_convert.hardnet_from_torch,
                 3.0, "logpolar"),
}


class PatchDescriptorExtractor:
    """Keypoints of any detector -> 32x32 patches -> descriptor network, on
    ``device``.

    ``checkpoint``: an official torch ``.pth`` / ``.pt`` (not for GeoDesc,
    which comes from TF1) or a JAX-package ``.npz`` of the flax variables;
    without one the network draws seeded random weights (``trained =
    False``), as the JAX package initialises from ``PRNGKey(0)``."""

    def __init__(self, kind: str, checkpoint: str | None = None, seed: int = 0, *,
                 device: torch.device | str = "cuda"):
        cls, self._from_jax, self._from_torch, self.mag_factor, sampler = \
            PATCH_DESCRIPTOR_REGISTRY[kind]
        self.kind = kind
        self.device = torch.device(device)
        self._extract = (extract_log_polar_patches if sampler == "logpolar"
                         else extract_oriented_patches)
        self.net = cls()
        self.trained = False
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, seed)
        self.net.to(self.device).eval()

    def load_checkpoint(self, path: str):
        if str(path).endswith((".pth", ".pt")):
            if self._from_torch is None:
                raise NotImplementedError(f"{self.kind}: TF1-era weights; supply the JAX "
                                          "package's converted .npz instead")
            state = self._from_torch(torch_convert.load_torch_file(path))
        else:
            state = self._from_jax(interop.read_npz(path))
        self.net.load_state_dict(state)
        self.net.to(self.device)
        self.trained = True

    def patches(self, img: torch.Tensor, xys, sizes, angles) -> torch.Tensor:
        return self._extract(img, xys, sizes, angles, patch_size=32,
                             mag_factor=self.mag_factor)

    def compute(self, img: torch.Tensor, xys, sizes, angles) -> torch.Tensor:
        """(H, W) image on the device, (N, 2) centres, (N,) sizes and
        angles (degrees, negative: unoriented) -> (N, 128) float32."""
        if len(xys) == 0:
            return torch.zeros((0, 128), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return self.net(self.patches(img, xys, sizes, angles))
