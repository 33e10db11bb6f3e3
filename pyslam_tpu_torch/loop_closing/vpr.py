"""Score-based VPR global descriptors: AlexNet conv3 and HDC-DELF (port of
``pyslam_tpu/loop_closing/vpr.py``).

ALEXNET: torchvision AlexNet ``features[:8]`` (conv1-conv3 with their
pools and ReLUs) on the ImageNet-normalised image resampled to 224 px,
average-pooled 2x2 and flattened in (y, x, channel) order as the JAX
package lays it out, L2-normalised.  HDC_DELF: DELF's local descriptors
(``models.delf``) projected to 4096-d hypervectors, bound to their
positions by the fractional-power codes cos(f * phase) of x and y, and
bundled (summed), L2-normalised.  The projection and the phases come from
``np.random.default_rng(7)`` in the reference's order, so both packages
hold the same codebooks.  Both compute on ``device`` and return host
arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import imagenet_square

ALEXNET_CONVS = (0, 3, 6)            # torchvision features indices


class AlexNetConv3(nn.Module):
    """torchvision AlexNet ``features[:8]`` (its state-dict indices)."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU())

    def forward(self, img):                  # (H, W, 3) ImageNet-normalised
        return self.features(img.permute(2, 0, 1)[None])[0]


def alexnet_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """A torchvision AlexNet state dict -> ``AlexNetConv3``'s (the first
    three convolutions)."""
    return {f"features.{i}.{leaf}": state_dict[f"features.{i}.{leaf}"]
            for i in ALEXNET_CONVS for leaf in ("weight", "bias")}


class AlexNetExtractor:
    """Whole image -> flattened conv3 descriptor (L2-normalised).  Without
    ``checkpoint`` (a torchvision AlexNet ``.pth``) seeded random weights
    (``trained = False``)."""

    def __init__(self, img_px: int = 224, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.img_px = img_px
        self.device = torch.device(device)
        self.net = AlexNetConv3()
        self.trained = False
        if checkpoint:
            from pyslam_tpu_torch.models.torch_convert import load_torch_file

            self.net.load_state_dict(alexnet_from_torch(load_torch_file(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def prepare(self, img) -> np.ndarray:
        return imagenet_square(img, self.img_px)

    def describe(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            f = F.avg_pool2d(self.net(x)[None], 2, 2)[0]       # (C, h, w)
            v = f.permute(1, 2, 0).reshape(-1)
            return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-9)

    def __call__(self, img) -> np.ndarray:
        return self.describe(torch.from_numpy(self.prepare(img)).to(self.device)).cpu().numpy()


class HDCDelfExtractor:
    """Hyperdimensional bundling of DELF local features: each descriptor
    projected to ``hdc_dim``, bound to its position by elementwise
    products with the x and y phase codes, summed over the valid
    keypoints.  Deterministic seeded codebooks; DELF's weights are its
    own (seeded random without a checkpoint)."""

    def __init__(self, hdc_dim: int = 4096, num_features: int = 400, seed: int = 7,
                 delf=None, *, device: torch.device | str = "cuda"):
        from pyslam_tpu_torch.models.delf import DELFExtractor

        self.device = torch.device(device)
        self.delf = delf or DELFExtractor(num_features=num_features, device=self.device)
        rng = np.random.default_rng(seed)
        desc_dim = self.delf.cfg.desc_dim
        proj = rng.normal(0, 1.0 / np.sqrt(desc_dim), (desc_dim, hdc_dim)).astype(np.float32)
        phase_x = rng.uniform(-np.pi, np.pi, hdc_dim).astype(np.float32)
        phase_y = rng.uniform(-np.pi, np.pi, hdc_dim).astype(np.float32)
        self.proj, self.phase_x, self.phase_y = (torch.from_numpy(a).to(self.device)
                                                 for a in (proj, phase_x, phase_y))

    @property
    def trained(self) -> bool:
        return self.delf.trained

    def bundle(self, desc, xy, valid, hw) -> torch.Tensor:
        """(N, d) descriptors at (N, 2) positions of an ``hw`` image ->
        the unit hypervector on the device."""
        h = desc @ self.proj
        hw = torch.tensor(hw, dtype=torch.float32, device=desc.device)
        fx = xy[:, 0] / hw[1]
        fy = xy[:, 1] / hw[0]
        code = (torch.cos(fx[:, None] * self.phase_x[None])
                * torch.cos(fy[:, None] * self.phase_y[None]))
        v = (h * code * valid.to(torch.float32)[:, None]).sum(0)
        return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-9)

    def __call__(self, img) -> np.ndarray:
        img = np.asarray(img, np.float32)
        fd = self.delf(img)
        with torch.no_grad():
            return self.bundle(fd.desc, fd.xy, fd.valid, img.shape[:2]).cpu().numpy()
