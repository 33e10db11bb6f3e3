"""R2D2 detector / descriptor, Quad_L2Net_ConfCFS (port of
``pyslam_tpu/models/r2d2.py``).

A fully convolutional L2-Net over the RGB image at full resolution: 3x3
convolutions of 32, 32, 64, 64, 128, 128 channels where each stride 2 of
L2-Net doubles the dilation instead, then three 2x2 convolutions (128,
128, 128) continuing the schedule; batch norm without affine (running
statistics) after each but the last, ReLU on the 3x3 body.  Heads on the
(128, H, W) map x: descriptors L2(x), reliability softmax(clf(x^2))[1],
repeatability softplus(sal(x^2)) / (1 + softplus).  The modules keep the
official ``ops`` list (its indices) and ``clf`` / ``sal``, so the
official checkpoint loads as it is (``torch_convert.r2d2_from_torch``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import feature_data, l2_normalize, rgb_image, single_level
from pyslam_tpu_torch.models.patch_descriptors import BN
from pyslam_tpu_torch.ops import nms as nms_ops

# (channels, kernel, dilation multiplier after the layer, batch norm, ReLU)
_LAYERS = [(32, 3, 1, True, True), (32, 3, 1, True, True), (64, 3, 2, True, True),
           (64, 3, 1, True, True), (128, 3, 2, True, True), (128, 3, 1, True, True),
           (128, 2, 2, True, False), (128, 2, 2, True, False), (128, 2, 2, False, False)]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class R2D2Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.ops = nn.ModuleList()
        cin, dilation = 3, 1
        for ch, k, dmul, bn, relu in _LAYERS:
            self.ops.append(nn.Conv2d(cin, ch, k, padding=dilation * (k - 1) // 2,
                                      dilation=dilation))
            if bn:
                self.ops.append(BN(ch))
            if relu:
                self.ops.append(nn.ReLU())
            cin, dilation = ch, dilation * dmul
        self.clf = nn.Conv2d(128, 2, 1)
        self.sal = nn.Conv2d(128, 1, 1)

    def forward(self, x):
        """(1, 3, H, W) ImageNet-normalised -> descriptors (128, H, W),
        reliability (H, W), repeatability (H, W)."""
        for op in self.ops:
            x = op(x)
        x2 = x * x
        rel = torch.softmax(self.clf(x2), dim=1)[0, 1]
        sp = F.softplus(self.sal(x2)[0, 0])
        return l2_normalize(x[0], 0), rel, sp / (1.0 + sp)


class R2D2Extractor:
    """(H, W) grey or (H, W, 3) image -> FeatureData on ``device``
    (``num_features`` slots, size 8, 128-d unit descriptors, L2).

    ``checkpoint``: the official ``r2d2_*.pt``; without one seeded random
    weights (``trained = False``)."""

    def __init__(self, num_features: int = 2000, checkpoint: str | None = None,
                 nms_cell: int = 8, *, device: torch.device | str = "cuda"):
        single_level(self, num_features, device)
        self.nms_cell = nms_cell
        self.net = R2D2Net()
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()
        self._mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=self.device)

    def load_checkpoint(self, path: str):
        from pyslam_tpu_torch.models import torch_convert

        self.net.load_state_dict(
            torch_convert.r2d2_from_torch(torch_convert.load_torch_file(path)))
        self.trained = True

    def maps(self, img: torch.Tensor) -> dict[str, torch.Tensor]:
        """(H, W, 3) float32 image on the device -> descriptors (128, H,
        W), reliability and repeatability (H, W)."""
        if float(img.max()) > 2.0:
            img = img / torch.tensor(255.0, device=img.device)   # a true division
        x = ((img - self._mean) / self._std).permute(2, 0, 1)[None]
        with torch.no_grad():
            desc, rel, rep = self.net(x)
        return {"desc": desc, "rel": rel, "rep": rep}

    def extract(self, img: torch.Tensor):
        m = self.maps(img)
        score = m["rel"] * m["rep"]
        xy, resp, valid = nms_ops.grid_topk_keypoints(score[None], cell=self.nms_cell,
                                                      per_cell=4, max_out=self.num_features)
        xy, resp, valid = xy[0], resp[0], valid[0]
        xi = torch.clamp(xy[:, 0].to(torch.int64), 0, score.shape[1] - 1)
        yi = torch.clamp(xy[:, 1].to(torch.int64), 0, score.shape[0] - 1)
        return feature_data(xy, resp, valid, m["desc"][:, yi, xi].T)

    def __call__(self, img):
        return self.extract(rgb_image(img, self.device))
