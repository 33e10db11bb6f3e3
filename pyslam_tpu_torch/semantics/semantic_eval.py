"""Semantic segmentation and semantic mapping metrics (port of
``pyslam_tpu/semantics/semantic_eval.py``, host numpy as there).

A confusion matrix (rows ground truth, columns prediction, one
``bincount``), per-class IoU, mIoU, pixel accuracy and the class-frequency
weighted IoU, over label images or over the fused labels of map points.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int,
                     ignore_label: int = -1) -> np.ndarray:
    """(num_classes, num_classes) confusion counts; rows = gt, cols = pred."""
    pred = np.asarray(pred).ravel()
    gt = np.asarray(gt).ravel()
    ok = (gt != ignore_label) & (gt >= 0) & (gt < num_classes) \
        & (pred >= 0) & (pred < num_classes)
    idx = gt[ok].astype(np.int64) * num_classes + pred[ok].astype(np.int64)
    return np.bincount(idx, minlength=num_classes ** 2).reshape(num_classes, num_classes)


@dataclass
class SemanticEvalResult:
    miou: float
    pixel_accuracy: float
    fw_iou: float                 # frequency-weighted IoU
    per_class_iou: np.ndarray     # (C,), NaN where class absent
    num_evaluated: int

    def __str__(self):
        return (f"mIoU={self.miou:.4f} pixel_acc={self.pixel_accuracy:.4f} "
                f"fwIoU={self.fw_iou:.4f} (n={self.num_evaluated})")


def evaluate_labels(pred, gt, num_classes: int, ignore_label: int = -1) -> SemanticEvalResult:
    cm = confusion_matrix(pred, gt, num_classes, ignore_label)
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.maximum(union, 1), np.nan)
    present = union > 0
    miou = float(np.nanmean(iou[present])) if present.any() else float("nan")
    total = cm.sum()
    pix_acc = float(inter.sum() / total) if total > 0 else float("nan")
    freq = cm.sum(1) / max(total, 1)
    fw = float(np.nansum(np.where(present, freq * iou, 0.0)))
    return SemanticEvalResult(miou, pix_acc, fw, iou, int(total))


def evaluate_map_points(slam_map, semantic_mapping, gt_label_of_point,
                        num_classes: int) -> SemanticEvalResult:
    """Fused per-map-point labels against a ground-truth labelling
    ``pid -> class`` (None or -1 skips the point)."""
    preds, gts = [], []
    for pid in np.nonzero(slam_map.points.valid)[0]:
        lab = semantic_mapping.point_label(int(pid))
        if lab is None or lab < 0:
            continue
        g = gt_label_of_point(int(pid))
        if g is None or g < 0:
            continue
        preds.append(lab)
        gts.append(g)
    return evaluate_labels(np.asarray(preds), np.asarray(gts), num_classes)
