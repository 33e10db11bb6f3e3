"""Semantic segmentation backends and their factory (port of
``pyslam_tpu/semantics/semantic_segmentation.py``).

``infer(img)`` returns the reference's dict of host numpy arrays:
``labels`` (H, W) int32 and, by backend, ``probs`` (H, W, C) float32,
``embeddings`` (H, W, D) float32 and ``instances``.  The networks run on
the backend's ``device`` (the card unless the caller passes
``device="cpu"``); their post-processing (NMS, mask painting, the
``np.ix_`` resampling) stays on the host, as in the reference, so that the
labels are the same.

- INTENSITY_BANDS: grey levels quantised into bands, host numpy; needs no
  weights, so a semantic session has a result to check.
- SEGFORMER, DEEPLABV3, YOLO, RF_DETR: the ported networks
  (``models.segformer``, ``deeplabv3``, ``yolo_seg``, ``detr``).
- CLIP (and the EOV_SEG / ODISE slots): the argmax text prompt per CLIP
  patch, upsampled; its ``probs`` are the patch-text softmax with the
  maximum subtracted first.  The reference exponentiates ``sim / 0.01``
  as it is, which overflows float32 above a cosine of ~0.887 and turns
  the probabilities NaN; wherever the reference is finite the two agree.
- DETIC: class-agnostic YOLO-seg proposals classified by CLIP crops.

No checkpoint is bundled: the learned backends run seeded random weights
(``trained = False``) unless a checkpoint is given.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class SemanticSegmentationType(enum.Enum):
    DEEPLABV3 = "deeplabv3"
    SEGFORMER = "segformer"
    CLIP = "clip"
    DETIC = "detic"
    YOLO = "yolo"
    RF_DETR = "rf_detr"
    EOV_SEG = "eov_seg"
    ODISE = "odise"
    INTENSITY_BANDS = "intensity_bands"


class SemanticDatasetType(enum.Enum):
    VOC = 21
    CITYSCAPES = 19
    ADE20K = 150
    CUSTOM = 0


class SemanticSegmentationBase:
    num_classes: int = 21
    device: torch.device | None = None     # the network's; None: host only

    def infer(self, img) -> dict:
        raise NotImplementedError

    @property
    def class_names(self):
        return [f"class_{i}" for i in range(self.num_classes)]


class IntensityBandSegmentation(SemanticSegmentationBase):
    """Quantise grey levels into bands (host numpy, no weights)."""

    def __init__(self, num_classes: int = 8):
        self.num_classes = num_classes

    def infer(self, img) -> dict:
        img = np.asarray(img, np.float32)
        labels = np.clip((img / 256.0 * self.num_classes).astype(np.int32), 0,
                         self.num_classes - 1)
        probs = np.zeros(labels.shape + (self.num_classes,), np.float32)
        np.put_along_axis(probs, labels[..., None], 0.9, axis=-1)
        probs += 0.1 / self.num_classes
        probs /= probs.sum(-1, keepdims=True)
        return {"labels": labels, "probs": probs}


class SegformerSegmentation(SemanticSegmentationBase):
    def __init__(self, num_classes: int = 19, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda"):
        from pyslam_tpu_torch.models.segformer import SegFormerInference

        self.num_classes = num_classes
        self.model = SegFormerInference(num_classes=num_classes, checkpoint=checkpoint,
                                        device=device)
        self.device = torch.device(device)

    def infer(self, img) -> dict:
        return self.model.infer(img)


def patch_softmax(sim: np.ndarray, temperature: float) -> np.ndarray:
    """Softmax of ``sim / temperature`` over the last axis, the maximum
    subtracted first (finite for any cosine)."""
    z = sim / temperature
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


class CLIPOpenVocabSegmentation(SemanticSegmentationBase):
    """Open-vocabulary dense segmentation from CLIP patch embeddings: the
    argmax text prompt per patch at pixel resolution, the softmaxed
    patch-text similarities as ``probs``, the patch embedding per pixel as
    ``embeddings``."""

    def __init__(self, labels: list | None = None, checkpoint: str | None = None,
                 temperature: float = 0.01, cfg=None, *, device: torch.device | str = "cuda"):
        from pyslam_tpu_torch.models.clip import CLIPModel

        self.model = CLIPModel(cfg=cfg, checkpoint=checkpoint, device=device)
        self.device = torch.device(device)
        self.temperature = temperature
        self.set_labels(labels or ["floor", "wall", "ceiling", "furniture", "object",
                                   "person", "vehicle", "vegetation"])

    def set_labels(self, labels: list):
        self.labels = list(labels)
        self.num_classes = len(self.labels)
        self.text_emb = self.model.encode_text([f"a photo of a {lab}" for lab in self.labels])

    @property
    def class_names(self):
        return self.labels

    def infer(self, img) -> dict:
        h, w = np.asarray(img).shape[:2]
        _, patch = self.model.encode_image(img, dense=True)   # (g, g, D)
        probs = patch_softmax(patch @ self.text_emb.T, self.temperature)
        g = patch.shape[0]
        ys = np.clip((np.arange(h) * g / h).astype(int), 0, g - 1)
        xs = np.clip((np.arange(w) * g / w).astype(int), 0, g - 1)
        probs = probs[np.ix_(ys, xs)]
        labels = probs.argmax(-1).astype(np.int32)
        emb = patch[np.ix_(ys, xs)]
        return {"labels": labels, "probs": probs.astype(np.float32),
                "embeddings": emb.astype(np.float32)}


class YoloSegmentation(SemanticSegmentationBase):
    """YOLO-seg instance segmentation; labels from the painted instance
    masks, class ``num_classes`` the background."""

    def __init__(self, num_classes: int = 8, checkpoint: str | None = None, cfg=None,
                 score_thr: float = 0.3, *, device: torch.device | str = "cuda"):
        from pyslam_tpu_torch.models.yolo_seg import YoloSeg, YoloSegConfig

        self.num_classes = num_classes + 1   # + background
        self.score_thr = score_thr
        self.model = YoloSeg(cfg or YoloSegConfig(num_classes=num_classes),
                             checkpoint=checkpoint, device=device)
        self.device = torch.device(device)

    def infer(self, img) -> dict:
        return self.model.infer(img, score_thr=self.score_thr)


class DetrSegmentation(SemanticSegmentationBase):
    """Detection-transformer backend (``models.detr``)."""

    def __init__(self, num_classes: int = 8, checkpoint: str | None = None, cfg=None,
                 score_thr: float = 0.5, *, device: torch.device | str = "cuda"):
        from pyslam_tpu_torch.models.detr import DetrConfig, DetrModel

        self.num_classes = num_classes + 1   # + no-object / background
        self.score_thr = score_thr
        self.model = DetrModel(cfg or DetrConfig(num_classes=num_classes),
                               checkpoint=checkpoint, device=device)
        self.device = torch.device(device)

    def infer(self, img) -> dict:
        return self.model.infer(img, score_thr=self.score_thr)


class DeticOpenVocabSegmentation(SemanticSegmentationBase):
    """Detic-style open vocabulary: class-agnostic mask proposals
    (YOLO-seg) classified by CLIP embeddings of their box crops against a
    text label list."""

    def __init__(self, labels: list | None = None, checkpoint: str | None = None, cfg=None,
                 clip_cfg=None, score_thr: float = 0.3, *,
                 device: torch.device | str = "cuda"):
        from pyslam_tpu_torch.models.clip import CLIPModel
        from pyslam_tpu_torch.models.yolo_seg import YoloSeg, YoloSegConfig

        self.score_thr = score_thr
        self.detector = YoloSeg(cfg or YoloSegConfig(num_classes=1), checkpoint=checkpoint,
                                device=device)
        self.clip = CLIPModel(cfg=clip_cfg, device=device)
        self.device = torch.device(device)
        self.set_labels(labels or ["chair", "table", "person", "screen", "door", "window",
                                   "plant", "box"])

    def set_labels(self, labels: list):
        self.labels = list(labels)
        self.num_classes = len(labels) + 1   # + background
        self.text_emb = self.clip.encode_text([f"a photo of a {lab}" for lab in self.labels])

    @property
    def class_names(self):
        return self.labels + ["background"]

    def infer(self, img) -> dict:
        img = np.asarray(img, np.float32)
        h, w = img.shape[:2]
        inst = self.detector.infer(img, score_thr=self.score_thr)["instances"]
        lab_map = np.full((h, w), len(self.labels), np.int32)
        classes = []
        for i in np.argsort(inst["scores"]):
            x1, y1, x2, y2 = inst["boxes"][i]
            x1, x2 = int(max(0, x1)), int(min(w - 1, x2))
            y1, y2 = int(max(0, y1)), int(min(h - 1, y2))
            if x2 <= x1 + 1 or y2 <= y1 + 1:
                classes.append(-1)
                continue
            emb = self.clip.encode_image(img[y1:y2, x1:x2])
            cls = int(np.argmax(emb @ self.text_emb.T))
            classes.append(cls)
            m = inst["masks"][i]
            my = np.clip((np.arange(y1, y2) * m.shape[0] / max(h, 1)).astype(int), 0,
                         m.shape[0] - 1)
            mx = np.clip((np.arange(x1, x2) * m.shape[1] / max(w, 1)).astype(int), 0,
                         m.shape[1] - 1)
            region = lab_map[y1:y2, x1:x2]
            region[m[np.ix_(my, mx)] > 0.5] = cls
        return {"labels": lab_map, "instances": {**inst, "clip_classes": np.array(classes)}}


def semantic_segmentation_factory(segmentation_type=SemanticSegmentationType.INTENSITY_BANDS,
                                  num_classes: int | None = None,
                                  checkpoint: str | None = None, *,
                                  device: torch.device | str = "cuda",
                                  **kw) -> SemanticSegmentationBase:
    if isinstance(segmentation_type, str):
        segmentation_type = SemanticSegmentationType(segmentation_type.lower())
    T = SemanticSegmentationType
    if segmentation_type == T.INTENSITY_BANDS:
        return IntensityBandSegmentation(num_classes or 8)
    if segmentation_type == T.SEGFORMER:
        return SegformerSegmentation(num_classes or 19, checkpoint, device=device)
    if segmentation_type == T.DEEPLABV3:
        from pyslam_tpu_torch.models.deeplabv3 import DeepLabV3Segmenter

        return DeepLabV3Segmenter(num_classes or 21, checkpoint, device=device)
    if segmentation_type in (T.CLIP, T.EOV_SEG, T.ODISE):
        # EOV-Seg / ODISE take the open-vocabulary slot: the CLIP
        # text-prompt path gives the same label-set-free surface
        return CLIPOpenVocabSegmentation(checkpoint=checkpoint, device=device, **kw)
    if segmentation_type == T.YOLO:
        return YoloSegmentation(num_classes or 8, checkpoint, device=device, **kw)
    if segmentation_type == T.RF_DETR:
        return DetrSegmentation(num_classes or 8, checkpoint, device=device, **kw)
    if segmentation_type == T.DETIC:
        return DeticOpenVocabSegmentation(checkpoint=checkpoint, device=device, **kw)
    raise NotImplementedError(f"segmentation backend {segmentation_type}")
