"""Inverted-index keyframe database (host copy of
``pyslam_tpu/loop_closing/keyframe_database.py``): word -> keyframes
lists, ORB-SLAM candidate scoring (common-word counting, min-score gate,
covisibility-group score accumulation)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class KeyFrameDatabase:
    def __init__(self, num_words: int):
        self.num_words = num_words
        self.inverted: dict[int, list[int]] = defaultdict(list)
        self.kf_words: dict[int, np.ndarray] = {}     # kid -> unique word ids
        self.kf_gdes: dict[int, np.ndarray] = {}      # kid -> global descriptor
        # DIRECT INDEX (reference DBoW direct index / SearchByBoW): the FULL
        # per-keypoint word assignment, kept so guided matching can restrict
        # candidate feature pairs to shared vocabulary subtrees
        self.kf_kp_words: dict[int, np.ndarray] = {}
        # per-word idf weights applied at QUERY time (see score()); None ->
        # plain normalized-tf dot product
        self.idf: np.ndarray | None = None

    def add(self, kid: int, words: np.ndarray | None, g_des: np.ndarray):
        """words=None -> score-based mode (VLAD/VPR-class detectors): only
        the global descriptor is stored and candidates are scored by pure
        similarity (reference ``loop_detector_vpr.py`` behavior)."""
        self.kf_gdes[kid] = g_des
        if words is None:
            self.kf_words[kid] = np.empty((0,), np.int64)
            return
        self.kf_kp_words[kid] = np.asarray(words, np.int64)
        uniq = np.unique(words[words >= 0])
        self.kf_words[kid] = uniq
        for w in uniq:
            self.inverted[int(w)].append(kid)

    def remove(self, kid: int):
        uniq = self.kf_words.pop(kid, None)
        self.kf_gdes.pop(kid, None)
        self.kf_kp_words.pop(kid, None)
        if uniq is None:
            return
        for w in uniq:
            lst = self.inverted.get(int(w))
            if lst and kid in lst:
                lst.remove(kid)

    def score(self, a: np.ndarray, b: np.ndarray) -> float:
        """Similarity of two stored tf vectors.

        With ``self.idf`` set (the vocabulary's CURRENT idf statistics,
        refreshed by the detector before each query), both sides are
        reweighted symmetrically at query time and cosine-compared — the
        DBoW3 tf-idf scoring without the incremental-drift problem of baking
        weights into stored descriptors (weights applied at query time are
        the same for database and query vector, so rankings stay coherent
        as documents arrive)."""
        w = self.idf
        if w is None:
            return float(a @ b)  # descriptors are L2-normalized
        aw = a * w
        bw = b * w
        na = float(np.linalg.norm(aw))
        nb = float(np.linalg.norm(bw))
        if na < 1e-12 or nb < 1e-12:
            return 0.0
        return float(aw @ bw) / (na * nb)

    def _common_word_counts(self, words: np.ndarray, exclude: set[int]):
        counts: dict[int, int] = defaultdict(int)
        for w in np.unique(words[words >= 0]):
            for kid in self.inverted.get(int(w), ()):
                if kid not in exclude:
                    counts[kid] += 1
        return counts

    def detect_loop_candidates(
        self,
        kid: int,
        words: np.ndarray,
        g_des: np.ndarray,
        connected: set[int],
        covisibles_of,  # callable kid -> list[kid]
        min_score: float | None = None,
    ) -> list[int]:
        """ORB-SLAM loop-candidate scoring: keyframes sharing >= 80% of the
        max common-word count, above min covisibility score, accumulated over
        their covisibility groups; return best-of-group keyframes whose group
        score >= 0.75 * best group score."""
        exclude = set(connected) | {kid}
        if words is None:
            # score-based mode: every stored keyframe is a candidate with a
            # zero word gate; similarity does the filtering
            counts = {k: 1 for k in self.kf_gdes if k not in exclude}
            th_common = 0.0
        else:
            counts = self._common_word_counts(words, exclude)
            if not counts:
                return []
            max_common = max(counts.values())
            th_common = max(0.8 * max_common, 1.0)
        if not counts:
            return []

        if min_score is None:
            # min score vs covisible keyframes (ORB-SLAM computes the minimum
            # similarity to the current KF's own neighbors)
            min_score = 0.05
            for nkid in connected:
                g = self.kf_gdes.get(nkid)
                if g is not None:
                    min_score = min(min_score, self.score(g_des, g))
            min_score = max(min_score, 0.01)

        scored = []
        for ckid, c in counts.items():
            if c < th_common:
                continue
            g = self.kf_gdes.get(ckid)
            if g is None:
                continue
            s = self.score(g_des, g)
            if s >= min_score:
                scored.append((ckid, s))
        if not scored:
            return []

        # accumulate group scores over covisibility neighborhoods
        best_group = []
        for ckid, s in scored:
            group = [ckid] + list(covisibles_of(ckid))[:10]
            acc = s
            best_kid, best_s = ckid, s
            for gk in group[1:]:
                g = self.kf_gdes.get(gk)
                if g is None or gk in exclude:
                    continue
                gs = self.score(g_des, g)
                # only count group members that themselves share words
                if counts.get(gk, 0) >= th_common * 0.5:
                    acc += gs
                if gs > best_s:
                    best_kid, best_s = gk, gs
            best_group.append((best_kid, acc))

        max_acc = max(a for _, a in best_group)
        out = []
        seen = set()
        for bkid, acc in best_group:
            if acc >= 0.75 * max_acc and bkid not in seen:
                out.append(bkid)
                seen.add(bkid)
        return out

    def detect_relocalization_candidates(self, words: np.ndarray | None,
                                         g_des: np.ndarray,
                                         max_out: int = 5) -> list[int]:
        if words is None:
            counts = {k: 1 for k in self.kf_gdes}
            th = 0.0
        else:
            counts = self._common_word_counts(words, set())
            if not counts:
                return []
            max_common = max(counts.values())
            th = max(0.5 * max_common, 1.0)
        if not counts:
            return []
        scored = [
            (kid, self.score(g_des, self.kf_gdes[kid]))
            for kid, c in counts.items()
            if c >= th and kid in self.kf_gdes
        ]
        scored.sort(key=lambda kv: -kv[1])
        return [k for k, _ in scored[:max_out]]
