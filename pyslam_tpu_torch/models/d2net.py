"""D2-Net detect-and-describe network (port of
``pyslam_tpu/models/d2net.py``).

VGG16 up to conv4_3 with D2-Net's changes: pool3 is a stride-1 2x2 average
pool (padded (0, 1) as flax pads it, the pad counted in the mean) and the
conv4 block has dilation 2, so the 512-channel feature map is at 1/4
resolution.  The soft detection score (``d2net_soft_scores``): a local
spatial ratio of exp(f - max f) over a 3x3 window times the channel ratio
f / max_c f, maxed over the channels.  The convolutions keep VGG's names
(``conv1_1`` ... ``conv4_3``); ``torch_convert.d2net_from_torch`` strips
the official ``dense_feature_extraction.model.`` prefix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import feature_data, l2_normalize, rgb_image, single_level
from pyslam_tpu_torch.ops import nms as nms_ops

VGG = [("conv1_1", 64, 1), ("conv1_2", 64, 1), ("pool", 0, 0),
       ("conv2_1", 128, 1), ("conv2_2", 128, 1), ("pool", 0, 0),
       ("conv3_1", 256, 1), ("conv3_2", 256, 1), ("conv3_3", 256, 1), ("avgpool_s1", 0, 0),
       ("conv4_1", 512, 2), ("conv4_2", 512, 2), ("conv4_3", 512, 2)]
_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


class D2Net(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for name, ch, dil in VGG:
            if name.startswith("conv"):
                self.add_module(name, nn.Conv2d(cin, ch, 3, padding=dil, dilation=dil))
                cin = ch

    def forward(self, x):
        """(1, 3, H, W) caffe-normalised BGR -> (1, 512, H/4, W/4)."""
        for name, _, _ in VGG:
            if name == "pool":
                x = F.max_pool2d(x, 2, stride=2)
            elif name == "avgpool_s1":
                x = F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, stride=1)
            else:
                x = getattr(self, name)(x)
                if name != "conv4_3":
                    x = F.relu(x)
        return x


def d2net_soft_scores(f: torch.Tensor) -> torch.Tensor:
    """(C, H, W) features -> (H, W) soft detection score (paper eqs. 4-6)."""
    h, w = f.shape[1:]
    e = torch.exp(f - f.max())
    p = F.pad(e, (1, 1, 1, 1))
    s = p[:, 0:h, 0:w]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                s = s + p[:, dy:dy + h, dx:dx + w]
    alpha = e / torch.clamp(s, min=1e-12)
    beta = f / torch.clamp(f.max(0, keepdim=True).values, min=1e-12)
    return (alpha * beta).max(0).values


class D2NetExtractor:
    """(H, W) grey or (H, W, 3) image -> FeatureData on ``device``
    (``num_features`` slots at the 4-px cells' centres, size 16, 512-d unit
    descriptors, L2).

    ``checkpoint``: the official ``d2_tf.pth`` (``model`` entry); without
    one seeded random weights (``trained = False``)."""

    def __init__(self, num_features: int = 2000, checkpoint: str | None = None,
                 nms_cell: int = 4, *, device: torch.device | str = "cuda"):
        single_level(self, num_features, device)
        self.nms_cell = nms_cell
        self.net = D2Net()
        if checkpoint:
            self.load_checkpoint(checkpoint)
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()
        self._mean = torch.tensor(_CAFFE_MEAN_BGR, dtype=torch.float32, device=self.device)

    def load_checkpoint(self, path: str):
        from pyslam_tpu_torch.models import torch_convert

        self.net.load_state_dict(
            torch_convert.d2net_from_torch(torch_convert.load_torch_file(path, "model")))
        self.trained = True

    def maps(self, img: torch.Tensor) -> dict[str, torch.Tensor]:
        """(H, W, 3) RGB float32 image on the device -> the feature map
        (512, H/4, W/4) of the crop to multiples of 4."""
        h, w = img.shape[:2]
        x = (img.flip(-1) - self._mean)[: h // 4 * 4, : w // 4 * 4]
        with torch.no_grad():
            f = self.net(x.permute(2, 0, 1)[None])[0]
        return {"feats": f}

    def extract(self, img: torch.Tensor):
        f = self.maps(img)["feats"]
        score = d2net_soft_scores(f)
        xy, resp, valid = nms_ops.grid_topk_keypoints(score[None], cell=self.nms_cell,
                                                      per_cell=2, max_out=self.num_features)
        xy, resp, valid = xy[0], resp[0], valid[0]
        xi = torch.clamp(xy[:, 0].to(torch.int64), 0, f.shape[2] - 1)
        yi = torch.clamp(xy[:, 1].to(torch.int64), 0, f.shape[1] - 1)
        return feature_data(xy * 4.0 + 2.0, resp, valid, l2_normalize(f[:, yi, xi].T, 1),
                            size=16.0)

    def __call__(self, img):
        return self.extract(rgb_image(img, self.device))
