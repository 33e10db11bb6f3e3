"""CosPlace / EigenPlaces place-recognition networks (port of
``pyslam_tpu/models/cosplace.py``).

Both hub models share one structure (gmberton's ``GeoLocalizationNet``):
a torchvision ResNet trunk -> L2 normalisation across channels -> GeM
pooling with a learnable p -> Linear -> L2 normalisation.  One module and
one converter serve both.  Images are ImageNet-normalised RGB, prepared on
the host as the JAX package prepares them and placed on a fixed
``image_hw`` canvas.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.resnet import ResNet

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class GeoLocalizationNet(nn.Module):
    """ResNet trunk + channel L2 norm -> GeM -> Linear -> L2 norm."""

    def __init__(self, arch: str = "resnet50", out_dim: int = 512, gem_eps: float = 1e-6,
                 width: int = 64):
        super().__init__()
        self.gem_eps = gem_eps
        self.backbone = ResNet(arch=arch, width=width)
        self.gem_p = nn.Parameter(torch.full((1,), 3.0))
        self.fc = nn.Linear(self.backbone.out_channels, out_dim)

    def forward(self, x):
        """(B, 3, H, W) ImageNet-normalised -> (B, out_dim) unit vectors."""
        f = self.backbone(x)
        f = f / torch.clamp(torch.linalg.vector_norm(f, dim=1, keepdim=True), min=1e-12)
        p = self.gem_p[0]
        f = torch.clamp(f, min=self.gem_eps) ** p
        f = f.mean(dim=(2, 3)) ** (1.0 / p)
        f = self.fc(f)
        return f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-12)


class CosPlaceExtractor:
    """Whole-image global descriptor for the score-based loop detector: a
    float32 unit vector (out_dim,) on the host, computed on ``device``.

    ``checkpoint``: an official ``.pth`` (arch and out_dim from its
    shapes), a JAX-package ``.npz`` (its ``__arch__``, ``__width__`` and
    ``__out_dim__``), or None for the bundled ``cosplace_tiny.npz``; random
    weights (``trained = False``) when there is none."""

    def __init__(self, arch: str = "resnet18", out_dim: int = 512,
                 checkpoint: str | None = None, image_hw=(480, 640), *,
                 device: torch.device | str = "cuda"):
        self.image_hw = tuple(image_hw)
        self.device = torch.device(device)
        self.trained = False
        width = 64
        if checkpoint and not str(checkpoint).endswith(".npz"):
            from pyslam_tpu_torch.models.torch_convert import cosplace_from_torch, load_torch_file

            state, arch, out_dim = cosplace_from_torch(load_torch_file(checkpoint))
        else:
            if checkpoint is None:
                checkpoint = interop.bundled_checkpoint("cosplace_tiny")
            state = None
            if checkpoint:
                flat = interop.read_npz(checkpoint)
                arch = str(flat["__arch__"])
                out_dim = int(flat["__out_dim__"])
                width = int(flat["__width__"])
                state = interop.cosplace_state_dict(flat)
        self.net = GeoLocalizationNet(arch=arch, out_dim=out_dim, width=width)
        if state is None:
            interop.seeded_init_(self.net, 0)
        else:
            self.net.load_state_dict(state)
            self.trained = True
        self.net.to(self.device).eval()
        self.out_dim = out_dim

    def prepare(self, img) -> np.ndarray:
        """Host pre-processing: grey -> 3 channels, /255 when the image
        is 8-bit valued, ImageNet normalisation, zero canvas of
        ``image_hw``.  Returns (H, W, 3) float32."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img / 255.0 if img.max() > 2.0 else img
        img = (img - _IMAGENET_MEAN) / _IMAGENET_STD
        H, W = self.image_hw
        h, w = img.shape[:2]
        canvas = np.zeros((H, W, 3), np.float32)
        canvas[: min(h, H), : min(w, W)] = img[:H, :W]
        return canvas

    def describe(self, canvas: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) prepared canvas on the device -> (out_dim,) on it."""
        with torch.no_grad():
            return self.net(canvas.permute(2, 0, 1)[None])[0]

    def __call__(self, img) -> np.ndarray:
        canvas = torch.from_numpy(self.prepare(img)).to(self.device)
        return self.describe(canvas).cpu().numpy()
