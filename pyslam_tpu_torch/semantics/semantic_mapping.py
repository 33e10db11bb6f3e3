"""Semantic mapping: per-keyframe segmentation fused into map points (port
of ``pyslam_tpu/semantics/semantic_mapping.py``).

Each keyframe local mapping hands over is segmented (the segmenter on its
device), its keypoints take the label under their rounded raw position
(``kf.kps_sem``), and the map points it observes accumulate class scores
(the probability vector, or one vote for the label) and, in
``FEATURE_VECTOR`` mode, a running mean of the per-pixel embedding.  The
fusion is host numpy, in the reference's order, so the scores are the
reference's.  ``get_semantic_weight`` gives local mapping's BA the
per-class information weights (``kUseSemanticsInOptimization``).  The
mapper listens to the map's point removals: a deleted point's
accumulators go, a replaced one's merge into its replacement.  One
keyframe is segmented a frame (``step``), the rest at ``run_all``.
"""

from __future__ import annotations

import enum
from collections import deque

import numpy as np
import torch

from pyslam_tpu_torch.semantics.semantic_segmentation import (
    SemanticSegmentationBase,
    semantic_segmentation_factory,
)


class SemanticFeatureType(enum.Enum):
    LABEL = "label"
    PROBABILITY_VECTOR = "probability_vector"
    FEATURE_VECTOR = "feature_vector"


def semantic_information_weights(dataset: str, num_classes: int) -> np.ndarray:
    """Per-class BA information weights: 1 everywhere but Cityscapes'
    'vegetation' (class 8), whose features are unstable, at 0.001; the
    trailing slot (unknown labels) 1."""
    w = np.ones(num_classes + 1, np.float32)
    if dataset.lower() == "cityscapes" and num_classes > 8:
        w[8] = 0.001
    return w


class SemanticMappingConfig:
    def __init__(self, segmentation_type="intensity_bands", num_classes: int = 8,
                 feature_type: SemanticFeatureType = SemanticFeatureType.PROBABILITY_VECTOR,
                 dataset: str = "custom"):
        self.segmentation_type = segmentation_type
        self.num_classes = num_classes
        self.feature_type = feature_type
        # the label set ("cityscapes", "voc", "ade20k", "nyu40", "custom"):
        # selects the BA information weights
        self.dataset = dataset


class SemanticMappingDense:
    """Per-keyframe segmentation and sparse map-point label fusion."""

    def __init__(self, slam_map, config: SemanticMappingConfig | None = None,
                 segmenter: SemanticSegmentationBase | None = None, *,
                 device: torch.device | str = "cuda"):
        self.config = config or SemanticMappingConfig()
        self.segmenter = segmenter or semantic_segmentation_factory(
            self.config.segmentation_type, self.config.num_classes, device=device)
        self.num_classes = self.segmenter.num_classes
        self._sem_weights = semantic_information_weights(self.config.dataset, self.num_classes)
        self.map = None
        self.reset(slam_map)

    def reset(self, slam_map):
        """Start over on ``slam_map``: drop the queue, the pending images and
        the accumulators, and listen to the new map's point removals."""
        if self.map is not None and self._on_point_removed in self.map.point_removal_listeners:
            self.map.point_removal_listeners.remove(self._on_point_removed)
        self.map = slam_map
        self.queue: deque = deque()
        self._pending_imgs: dict[int, np.ndarray] = {}
        self.point_scores: dict[int, np.ndarray] = {}
        # FEATURE_VECTOR mode: running mean of the embeddings a point saw
        self.point_embeddings: dict[int, np.ndarray] = {}
        self.point_embedding_counts: dict[int, int] = {}
        slam_map.point_removal_listeners.append(self._on_point_removed)

    def _on_point_removed(self, old_pid: int, new_pid: int | None):
        scores = self.point_scores.pop(old_pid, None)
        emb = self.point_embeddings.pop(old_pid, None)
        cnt = self.point_embedding_counts.pop(old_pid, 0)
        if new_pid is None:
            return
        if scores is not None:
            acc = self.point_scores.get(new_pid)
            self.point_scores[new_pid] = scores if acc is None else acc + scores
        if emb is not None:
            n_new = self.point_embedding_counts.get(new_pid, 0)
            mean_new = self.point_embeddings.get(new_pid)
            if mean_new is None:
                self.point_embeddings[new_pid] = emb
                self.point_embedding_counts[new_pid] = cnt
            else:
                tot = n_new + cnt
                self.point_embeddings[new_pid] = (mean_new * n_new + emb * cnt) / max(tot, 1)
                self.point_embedding_counts[new_pid] = tot

    def offer_keyframe_image(self, kid: int, img):
        """The image of a keyframe just created (frames keep no images):
        ``Slam.track`` offers it, ``add_keyframe`` takes it when local
        mapping hands the keyframe over."""
        self._pending_imgs[kid] = img

    def add_keyframe(self, kf, img=None):
        if img is None:
            img = self._pending_imgs.pop(kf.kid, None)
        if img is None:
            img = getattr(kf, "img", None)
        if img is None:
            return
        self.queue.append((kf, img))

    def step(self) -> bool:
        if not self.queue:
            return False
        kf, img = self.queue.popleft()
        self.process_keyframe(kf, img)
        return True

    def run_all(self):
        while self.step():
            pass

    def process_keyframe(self, kf, img):
        out = self.segmenter.infer(img)
        labels = out["labels"]
        probs = out.get("probs")
        embeddings = out.get("embeddings")       # (H, W, D) open-vocabulary backends
        h, w = labels.shape
        xs = np.clip(np.round(kf.kps_raw[:, 0]).astype(int), 0, w - 1)
        ys = np.clip(np.round(kf.kps_raw[:, 1]).astype(int), 0, h - 1)
        kp_labels = labels[ys, xs]
        kf.kps_sem = kp_labels
        slots = np.nonzero(kf.points >= 0)[0]
        sy, sx = ys[slots], xs[slots]
        use_probs = (probs is not None
                     and self.config.feature_type == SemanticFeatureType.PROBABILITY_VECTOR)
        if use_probs:
            rows = probs[sy, sx].astype(np.float32)
        else:
            rows = np.zeros((len(slots), self.num_classes), np.float32)
            rows[np.arange(len(slots)), kp_labels[slots]] = 1.0
        embs = (embeddings[sy, sx] if embeddings is not None
                and self.config.feature_type == SemanticFeatureType.FEATURE_VECTOR else None)
        for j, pid in enumerate(kf.points[slots].tolist()):
            acc = self.point_scores.get(pid)
            if acc is None:
                acc = self.point_scores[pid] = np.zeros(self.num_classes, np.float32)
            acc += rows[j]
            if embs is not None:
                e = embs[j]
                n = self.point_embedding_counts.get(pid, 0)
                mean = self.point_embeddings.get(pid)
                self.point_embeddings[pid] = e.copy() if mean is None else (mean * n + e) / (n + 1)
                self.point_embedding_counts[pid] = n + 1

    def point_label(self, pid: int) -> int:
        acc = self.point_scores.get(int(pid))
        return int(np.argmax(acc)) if acc is not None else -1

    def get_semantic_weight(self, labels) -> np.ndarray:
        """Per-observation information weight of keypoint labels (scalar or
        array); -1 and out-of-range labels weigh 1."""
        labels = np.asarray(labels, np.int64)
        safe = np.where((labels >= 0) & (labels < self.num_classes), labels, self.num_classes)
        return self._sem_weights[safe]

    def point_confidence(self, pid: int) -> float:
        acc = self.point_scores.get(int(pid))
        if acc is None or acc.sum() <= 0:
            return 0.0
        return float(acc.max() / acc.sum())

    def point_embedding(self, pid: int):
        """The fused unit embedding of a map point (FEATURE_VECTOR mode)."""
        e = self.point_embeddings.get(int(pid))
        if e is None:
            return None
        return e / max(np.linalg.norm(e), 1e-9)

    def query_points_by_text(self, text: str, clip_model=None, top_k: int = 50):
        """Rank the fused map points against a text prompt: (pids,
        similarities), most similar first."""
        if clip_model is None:
            clip_model = getattr(self.segmenter, "model", None)
        if clip_model is None or not self.point_embeddings:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        t = clip_model.encode_text([f"a photo of a {text}"])[0]
        pids = np.fromiter(self.point_embeddings.keys(), np.int64)
        embs = np.stack([self.point_embedding(p) for p in pids])
        sims = embs @ t
        order = np.argsort(-sims)[:top_k]
        return pids[order], sims[order].astype(np.float32)


def semantic_mapping_factory(slam_map, config=None, **kw) -> SemanticMappingDense:
    return SemanticMappingDense(slam_map, config, **kw)
