"""YOLOv8-seg-class one-stage instance segmentation (port of
``pyslam_tpu/models/yolo_seg.py``).

- A CSP backbone: a stem and four stride-2 ``ConvBNSiLU`` downsamplings
  with ``C2f`` blocks (split, bottlenecks on one half, concatenate all),
  giving P3/P4/P5 at strides 8/16/32.
- A PAN neck: top-down nearest 2x upsampling and concatenation, then
  bottom-up stride-2 re-aggregation.
- A prototype head on P3 (K mask prototypes at 1/8) and decoupled heads
  per level: class logits, ltrb box offsets, K mask coefficients.

Convolutions use flax's "SAME" padding, batch norm the running statistics
(``resnet.BN``).  The decode runs on the device as the JAX package's jitted
graph does: sigmoid scores, the top ``topk_per_level`` cells a level by the
best class score (a stable descending sort: ``lax.top_k`` keeps the lower
index on ties), softplus ltrb distances times the stride, and the masks as
``sigmoid(proto . coefficients)``.  The greedy NMS (``_nms``) and the
painting of the label map stay on the host, as in the reference, so the
labels come out the same.  The modules carry the JAX package's names; a
checkpoint is its ``.npz`` (``interop.yolo_seg_state_dict``).  Without
one the weights are seeded random ones (``trained = False``).  The
convolutions run under cuDNN's autotuned algorithms.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.layers import (autotuned_convs, conv_same, softplus,
                                            truncation_resample)
from pyslam_tpu_torch.models.resnet import BN

STRIDES = (8, 16, 32)


@dataclass(frozen=True)
class YoloSegConfig:
    img_px: int = 256          # square working resolution (/32)
    width: int = 32            # base channels
    num_classes: int = 8
    num_protos: int = 16
    topk_per_level: int = 64
    max_det: int = 64


class ConvBNSiLU(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride, bias=False)
        self.bn = BN(features)

    def forward(self, x):
        return F.silu(self.bn(conv_same(self.conv, x)))


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, shortcut: bool = True):
        super().__init__()
        self.add = shortcut and in_ch == features
        self.cv1 = ConvBNSiLU(in_ch, features)
        self.cv2 = ConvBNSiLU(features, features)

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, in_ch: int, features: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        h = features // 2
        self.n = n
        self.cv1 = ConvBNSiLU(in_ch, 2 * h, kernel=1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(h, h, shortcut))
        self.cv2 = ConvBNSiLU((2 + n) * h, features, kernel=1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, 1)
        outs = [a, b]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
            outs.append(b)
        return self.cv2(torch.cat(outs, 1))


def _up(x, ref):
    """``jax.image.resize(..., "nearest")``: source floor((i + 0.5) * in / out)."""
    return F.interpolate(x, size=tuple(ref.shape[-2:]), mode="nearest-exact")


class YoloSegNet(nn.Module):
    def __init__(self, cfg: YoloSegConfig):
        super().__init__()
        self.cfg = c = cfg
        w = c.width
        self.stem = ConvBNSiLU(3, w, stride=2)
        self.down1 = ConvBNSiLU(w, 2 * w, stride=2)
        self.c2f1 = C2f(2 * w, 2 * w)
        self.down2 = ConvBNSiLU(2 * w, 4 * w, stride=2)
        self.c2f2 = C2f(4 * w, 4 * w, n=2)
        self.down3 = ConvBNSiLU(4 * w, 8 * w, stride=2)
        self.c2f3 = C2f(8 * w, 8 * w, n=2)
        self.down4 = ConvBNSiLU(8 * w, 16 * w, stride=2)
        self.c2f4 = C2f(16 * w, 16 * w)
        self.neck_td4 = C2f(24 * w, 8 * w, shortcut=False)
        self.neck_td3 = C2f(12 * w, 4 * w, shortcut=False)
        self.neck_bu3 = ConvBNSiLU(4 * w, 4 * w, stride=2)
        self.neck_bu4 = C2f(12 * w, 8 * w, shortcut=False)
        self.neck_bu5 = ConvBNSiLU(8 * w, 8 * w, stride=2)
        self.neck_bu6 = C2f(24 * w, 16 * w, shortcut=False)
        self.proto1 = ConvBNSiLU(4 * w, 2 * w)
        self.proto2 = nn.Conv2d(2 * w, c.num_protos, 1)
        for name, ch in (("p3", 4 * w), ("p4", 8 * w), ("p5", 16 * w)):
            for head, out in (("cls", c.num_classes), ("box", 4), ("m", c.num_protos)):
                self.add_module(f"head_{name}_{head}1", ConvBNSiLU(ch, 2 * w))
                self.add_module(f"head_{name}_{head}2", nn.Conv2d(2 * w, out, 1))

    def forward(self, img):
        """(S, S, 3) in [0, 1] -> ([(cls, box, coef) (C, g, g) a level], proto
        (K, S/8, S/8))."""
        x = self.c2f1(self.down1(self.stem(img.permute(2, 0, 1)[None])))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.c2f4(self.down4(p4))
        n4 = self.neck_td4(torch.cat([_up(p5, p4), p4], 1))
        n3 = self.neck_td3(torch.cat([_up(n4, p3), p3], 1))
        n4 = self.neck_bu4(torch.cat([self.neck_bu3(n3), n4], 1))
        n5 = self.neck_bu6(torch.cat([self.neck_bu5(n4), p5], 1))
        proto = self.proto2(self.proto1(n3))[0]
        outs = []
        for name, f in (("p3", n3), ("p4", n4), ("p5", n5)):
            outs.append(tuple(getattr(self, f"head_{name}_{h}2")(
                getattr(self, f"head_{name}_{h}1")(f))[0] for h in ("cls", "box", "m")))
        return outs, proto


def decode(outs, proto, cfg: YoloSegConfig):
    """The network's outputs -> (scores, labels, boxes (x1, y1, x2, y2) in
    network pixels, masks (N, S/8, S/8)) of the top cells of each level."""
    cand = []
    for li, (cls, box, coef) in enumerate(outs):
        stride = STRIDES[li]
        g = cls.shape[-1]
        score = torch.sigmoid(cls).permute(1, 2, 0).reshape(g * g, cfg.num_classes)
        best = score.max(1).values
        lab = torch.argmax(score, 1).to(torch.int32)
        k = min(cfg.topk_per_level, g * g)
        v, idx = torch.sort(best, descending=True, stable=True)
        v, idx = v[:k], idx[:k]
        gy = torch.div(idx, g, rounding_mode="floor").to(torch.float32) + 0.5
        gx = (idx % g).to(torch.float32) + 0.5
        ltrb = softplus(box.permute(1, 2, 0).reshape(g * g, 4)[idx]) * stride
        xyxy = torch.stack([gx * stride - ltrb[:, 0], gy * stride - ltrb[:, 1],
                            gx * stride + ltrb[:, 2], gy * stride + ltrb[:, 3]], 1)
        cand.append((v, lab[idx], xyxy,
                     coef.permute(1, 2, 0).reshape(g * g, cfg.num_protos)[idx]))
    scores, labels, boxes, coefs = (torch.cat(parts) for parts in zip(*cand))
    masks = torch.sigmoid(torch.einsum("khw,nk->nhw", proto, coefs))
    return scores, labels, boxes, masks


class YoloSeg:
    """Instance segmentation -> a semantic label map and the instances;
    the network and its decode on ``device``."""

    def __init__(self, cfg: YoloSegConfig | None = None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or YoloSegConfig()
        self.device = torch.device(device)
        self.net = YoloSegNet(self.cfg)
        self.trained = False
        if checkpoint:
            self.net.load_state_dict(interop.yolo_seg_state_dict(interop.read_npz(checkpoint)))
            self.trained = True
        else:
            interop.seeded_init_(self.net, 0)
        self.net.to(self.device).eval()

    def prepare(self, img) -> np.ndarray:
        """Host pre-processing: grey -> 3 channels, the network square by
        ``floor(i * H / S)`` sampling, /255 when 8-bit valued."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        x = truncation_resample(img, (self.cfg.img_px, self.cfg.img_px))
        return np.ascontiguousarray(x / 255.0 if x.max() > 2.0 else x, np.float32)

    def run(self, x: np.ndarray):
        """Prepared image -> the decoded candidates on the device."""
        with torch.no_grad(), autotuned_convs():
            outs, proto = self.net(torch.from_numpy(x).to(self.device))
            return decode(outs, proto, self.cfg)

    @staticmethod
    def _nms(boxes, scores, iou_thr=0.5, max_det=64):
        order = np.argsort(-scores)
        keep = []
        while len(order) and len(keep) < max_det:
            i = order[0]
            keep.append(i)
            if len(order) == 1:
                break
            rest = order[1:]
            xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
            yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
            xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
            yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
            inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
            a = ((boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
                 + (boxes[rest, 2] - boxes[rest, 0])
                 * (boxes[rest, 3] - boxes[rest, 1]) - inter)
            order = rest[inter / np.maximum(a, 1e-9) < iou_thr]
        return np.array(keep, int)

    def infer(self, img, score_thr: float = 0.3) -> dict:
        """The decoded candidates, then on the host: the score threshold,
        NMS, the label map painted lowest score first (background
        ``num_classes``), resampled to the image's size."""
        H, W = np.asarray(img).shape[:2]
        S = self.cfg.img_px
        scores, labels, boxes, masks = (o.cpu().numpy() for o in self.run(self.prepare(img)))
        sel = scores >= score_thr
        scores, labels, boxes, masks = scores[sel], labels[sel], boxes[sel], masks[sel]
        if len(scores):
            keep = self._nms(boxes, scores, max_det=self.cfg.max_det)
            scores, labels, boxes, masks = scores[keep], labels[keep], boxes[keep], masks[keep]
        lab_map = np.full((S, S), self.cfg.num_classes, np.int32)
        for i in np.argsort(scores):         # highest painted last (wins)
            m = masks[i]
            m = m.repeat(S // m.shape[0], 0).repeat(S // m.shape[1], 1)
            x1, y1, x2, y2 = np.clip(boxes[i], 0, S - 1).astype(int)
            crop = np.zeros_like(m, bool)
            crop[y1:y2 + 1, x1:x2 + 1] = True
            lab_map[(m > 0.5) & crop] = labels[i]
        ys = np.clip((np.arange(H) * S / H).astype(int), 0, S - 1)
        xs = np.clip((np.arange(W) * S / W).astype(int), 0, S - 1)
        sx, sy = W / S, H / S
        boxes_img = boxes * np.array([sx, sy, sx, sy]) if len(boxes) else boxes
        return {"labels": lab_map[np.ix_(ys, xs)],
                "instances": {"scores": scores, "classes": labels,
                              "boxes": boxes_img, "masks": masks}}
