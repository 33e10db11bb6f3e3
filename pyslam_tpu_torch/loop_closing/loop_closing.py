"""Loop closing: detect -> consistency -> geometry -> correct (port of the
bag-of-words branch of ``pyslam_tpu/loop_closing/loop_closing.py``).

Detection: the keyframe's descriptors are quantised on the device against
a session-trained vocabulary; the inverted-index database proposes
candidates, which must stay consistent over covisibility groups.
Geometry check: the current keyframe's map points matched against the
candidate's covisible map (direct-index guided Hamming matching), a
batched Sim(3) RANSAC scored by mutual reprojection with minimal sets
weighted toward near points, a Sim(3) LM refinement, and enrichment by
projecting the loop side through the estimate.  Correction: local mapping
is drained, the Sim(3) is propagated to the current covisibility group and
its points, loop points are fused, the essential graph is optimised over
Sim(3) (with ORB-SLAM's loop connections and point references, where the
reference departs from them: ``_essential_graph_pgo``), and a global BA is
dispatched to run asynchronously.

Host bookkeeping is numpy; the matching, RANSAC, LM, pose graph and BA run
on the device.  ``save``/``load`` carry the DB and the vocabulary with the
system state.  The score-based detectors describe a keyframe by one
global descriptor and the database scores them by similarity alone: the
learned COSPLACE / EIGENPLACES (``models.cosplace``), NETVLAD
(``models.netvlad``), MEGALOC (``models.megaloc``), ALEXNET and HDC_DELF
(``loop_closing.vpr``), and the weight-free VLAD over the keyframe's local
descriptors and SAD over its thumbnail (``loop_closing.vlad``).  As in the
reference, ``save``/``load`` do not carry a VLAD vocabulary.
"""

from __future__ import annotations

import importlib
import os
from collections import deque

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.loop_closing.keyframe_database import KeyFrameDatabase
from pyslam_tpu_torch.loop_closing.loop_detector_configs import (
    GlobalDescriptorType,
    LoopDetectorConfig,
    LoopDetectorConfigs,
    LoopDetectorVocabularyType,
)
from pyslam_tpu_torch.loop_closing.relocalizer import Relocalizer
from pyslam_tpu_torch.loop_closing.vocabulary import BinaryVocabulary, HierarchicalVocabulary
from pyslam_tpu_torch.ops import hamming, matching, optim, procrustes, slam_matching
from pyslam_tpu_torch.ops.epipolar import generator_sampler
from pyslam_tpu_torch.slam.frame import KeyFrame
from pyslam_tpu_torch.slam.global_bundle_adjustment import AsyncGBA
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.utils.logging import Printer
from pyslam_tpu_torch.utils.padding import pad_bucket, pad_rows
from pyslam_tpu_torch.utils.profiling import StageTimings

_G = GlobalDescriptorType
# the learned whole-image detectors: (module, extractor class)
_VPR_EXTRACTORS = {
    _G.NETVLAD: ("pyslam_tpu_torch.models.netvlad", "NetVLADExtractor"),
    _G.MEGALOC: ("pyslam_tpu_torch.models.megaloc", "MegaLocExtractor"),
    _G.ALEXNET: ("pyslam_tpu_torch.loop_closing.vpr", "AlexNetExtractor"),
    _G.HDC_DELF: ("pyslam_tpu_torch.loop_closing.vpr", "HDCDelfExtractor"),
    _G.COSPLACE: ("pyslam_tpu_torch.models.cosplace", "CosPlaceExtractor"),
    _G.EIGENPLACES: ("pyslam_tpu_torch.models.cosplace", "CosPlaceExtractor"),
}


def _mean_descriptor(frame) -> np.ndarray:
    """The unit mean of a frame's valid descriptors (the fallback of the
    image detectors for a frame that kept no image)."""
    v = np.asarray(frame.des[frame.valid], np.float32).mean(axis=0)
    return v / max(np.linalg.norm(v), 1e-12)


class LoopDetector:
    """A frame's descriptors for the keyframe database.  The BoW detectors
    return (word ids, tf histogram) against a session-trained vocabulary,
    or a pretrained one (``PRETRAINED``: ``extra["vocabulary_path"]``, a
    vocabulary ``.npz`` of either package, ``HierarchicalVocabulary.load``).
    The score-based detectors return (None, global descriptor): the learned
    image detectors (held in ``netvlad``, the reference's name) describe
    the frame's retained half-resolution image and set
    ``Parameters.kRetainImageForVPR`` (for every later frame of the
    process, as the reference does); VLAD describes its local descriptors,
    SAD its thumbnail.  A frame without its image falls back to its mean
    descriptor."""

    def __init__(self, config: LoopDetectorConfig, *, device: torch.device | str = "cuda"):
        gdt = config.global_descriptor_type
        self.config = config
        vt = config.vocabulary_type
        if vt == LoopDetectorVocabularyType.PRETRAINED:
            self.vocabulary = HierarchicalVocabulary.load(config.extra["vocabulary_path"],
                                                          device=device)
        elif vt == LoopDetectorVocabularyType.HIERARCHICAL_SESSION:
            self.vocabulary = HierarchicalVocabulary(branching=8, depth=4, device=device)
        else:
            self.vocabulary = BinaryVocabulary(num_words=config.num_words, device=device)
        self._trained = False
        self._train_buffer: list[np.ndarray] = []
        self.vlad = None
        self.netvlad = None
        if gdt == _G.VLAD:
            from pyslam_tpu_torch.loop_closing.vlad import VladVocabulary

            self.vlad = VladVocabulary(num_clusters=config.num_words, device=device)
        if gdt in _VPR_EXTRACTORS:
            module, cls = _VPR_EXTRACTORS[gdt]
            Parameters.kRetainImageForVPR = True
            kw = {} if gdt == _G.HDC_DELF else {"checkpoint": config.extra.get("checkpoint")}
            self.netvlad = getattr(importlib.import_module(module), cls)(**kw, device=device)
        self.score_based = gdt in (_G.VLAD, _G.SAD) or self.netvlad is not None

    def describe_frame(self, frame):
        gdt = self.config.global_descriptor_type
        if self.netvlad is not None:
            img = frame.img_vpr if frame.img_vpr is not None else frame.img_thumb
            return None, (self.netvlad(img) if img is not None else _mean_descriptor(frame))
        if gdt == _G.VLAD:
            return None, self.vlad.global_descriptor(frame.dev("des"), frame.dev("valid"))
        if gdt == _G.SAD:
            from pyslam_tpu_torch.loop_closing.vlad import sad_descriptor

            if frame.img_thumb is None:
                return None, _mean_descriptor(frame)
            img = torch.as_tensor(np.asarray(frame.img_thumb, np.float32)).to(
                self.vocabulary.device)
            return None, sad_descriptor(img).cpu().numpy()
        if (self.config.vocabulary_type == LoopDetectorVocabularyType.SESSION_TRAINED
                and not self._trained):
            valid = frame.valid
            self._train_buffer.append(frame.des[valid][:: max(1, valid.sum() // 200)])
            if sum(len(b) for b in self._train_buffer) > 4000:
                self.vocabulary.train_kmeans(np.concatenate(self._train_buffer))
                self._trained = True
                self._train_buffer.clear()
        words = self.vocabulary.words_for(frame.dev("des"), frame.dev("valid"))
        return words, self.vocabulary.global_descriptor(words)


class LoopGroupConsistencyChecker:
    """Covisibility-group consistency across detections."""

    def __init__(self, min_consistency: int | None = None):
        self.min_consistency = min_consistency or Parameters.kLoopClosingMinNumConsistentGroups
        self.prev_groups: list[tuple[set, int]] = []

    def check(self, candidates: list[int], group_of) -> list[int]:
        """The candidates whose group has been consistent long enough."""
        accepted = []
        new_groups: list[tuple[set, int]] = []
        for cand in candidates:
            group = set(group_of(cand)) | {cand}
            count = 0
            for prev, c in self.prev_groups:
                if group & prev:
                    count = max(count, c + 1)
            new_groups.append((group, count))
            if count >= self.min_consistency - 1:
                accepted.append(cand)
        self.prev_groups = new_groups
        return accepted

    def reset(self):
        self.prev_groups = []


class LoopClosing:
    """``sampler`` (optional) replaces the RANSAC's minimal-sample draws,
    see ``ops.epipolar.generator_sampler``; by default they come from a
    ``torch.Generator`` seeded 11."""

    def __init__(self, slam_map: Map, camera, feature_tracker,
                 detector_config: LoopDetectorConfig | str = "DBOW3",
                 sensor_type: SensorType = SensorType.MONOCULAR, *,
                 device: torch.device | str = "cuda", sampler=None):
        if isinstance(detector_config, str):
            detector_config = LoopDetectorConfigs.get(detector_config)
        self.device = torch.device(device)
        self.map = slam_map
        self.camera = camera
        self.tracker = feature_tracker
        self.sensor_type = sensor_type
        self.detector = LoopDetector(detector_config, device=self.device)
        self.db = KeyFrameDatabase(self.detector.vocabulary.num_words)
        self.consistency = LoopGroupConsistencyChecker()
        self.relocalizer = Relocalizer(camera, self.db, self.detector, device=self.device)
        self.local_mapping = None   # set by Slam (drained before a correction)
        self.queue: deque[KeyFrame] = deque()
        self.last_loop_kf_id = -1
        self.num_loops_closed = 0
        self.gba = AsyncGBA(camera, feature_tracker, device=self.device)
        self.sampler = sampler if sampler is not None else generator_sampler(self.device, 11)
        self.timings = StageTimings("loop_closing")
        self.last_geometry: dict = {}   # counts of the last geometry check
        self.last_pgo_size = (0, 0)     # (vertices, edges) of the last PGO
        # the acceptance counts assume a 2000-feature budget; scale them like
        # the keyframe-decision thresholds
        feat_scale = min(1.0, feature_tracker.num_features / 2000.0)
        self.min_bow_matches = max(
            12, int(Parameters.kLoopClosingGeometryCheckerMinNumBoWMatches * feat_scale))
        self.min_sim3_inliers = max(10, int(Parameters.kSim3SolverMinInliers * feat_scale))
        self.min_matched_points = max(
            18, int(Parameters.kLoopClosingMinNumMatchedMapPoints * feat_scale))
        dev = self.device
        self._K = torch.as_tensor(np.asarray(camera.K, np.float32)).to(dev)
        self._ib = torch.tensor([camera.u_min, camera.u_max, camera.v_min, camera.v_max],
                                dtype=torch.float32, device=dev)
        self._sf = torch.as_tensor(feature_tracker.scale_factors).to(dev)
        self._sigma2 = torch.as_tensor(np.asarray(feature_tracker.sigma2, np.float32)).to(dev)
        self._bf = torch.tensor(camera.bf, dtype=torch.float32, device=dev)

    def _put(self, x, dtype=np.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype)).to(self.device)

    # --------------------------------------------------------- state machine
    def reset(self):
        """Clear the session's loop-closing state."""
        self.queue.clear()
        self.db = KeyFrameDatabase(self.detector.vocabulary.num_words)
        self.relocalizer.keyframe_db = self.db
        self.consistency.reset()
        self.last_loop_kf_id = -1
        self.num_loops_closed = 0
        self.gba._state = None          # discard a solve in flight
        self.gba.abort_flag = False

    def save(self, path: str):
        """Write the loop-closing DB to ``path``: ``loop_closing_state.npz``
        (inverted index, per-keypoint words, global descriptors, counters;
        a flat codebook's words inline) and, for a tree vocabulary,
        ``loop_vocabulary.npz`` with its checksum in the state.  The JAX
        package's layout: either package loads the other's."""
        db = self.db
        kids = np.asarray(sorted(db.kf_gdes.keys()), np.int64)
        gdes = (np.stack([db.kf_gdes[int(k)] for k in kids]) if len(kids)
                else np.zeros((0, 0), np.float32))
        words_flat = (np.concatenate([db.kf_words[int(k)] for k in kids]) if len(kids)
                      else np.zeros((0,), np.int64))
        offsets = np.cumsum([0] + [len(db.kf_words[int(k)]) for k in kids]).astype(np.int64)
        empty = np.zeros((0,), np.int64)
        kp_lists = [db.kf_kp_words.get(int(k), empty) for k in kids]
        kp_flat = np.concatenate(kp_lists) if len(kids) else empty
        kp_offsets = np.cumsum([0] + [len(a) for a in kp_lists]).astype(np.int64)
        state = {
            "kids": kids,
            "gdes": gdes,
            "words_flat": words_flat,
            "word_offsets": offsets,
            "kp_words_flat": kp_flat,          # direct index (per-keypoint words)
            "kp_word_offsets": kp_offsets,
            "last_loop_kf_id": self.last_loop_kf_id,
            "num_loops_closed": self.num_loops_closed,
        }
        voc = self.detector.vocabulary
        if voc.seeded:
            if isinstance(voc, HierarchicalVocabulary):
                voc.save(os.path.join(path, "loop_vocabulary.npz"))
                state["voc_checksum"] = voc.checksum()
            else:
                state.update(voc_words_bits=voc.words_bits, voc_doc_count=voc.doc_count,
                             voc_word_doc_count=voc.word_doc_count)
        np.savez_compressed(os.path.join(path, "loop_closing_state.npz"), **state)

    def load(self, path: str) -> bool:
        """Restore the DB that ``save`` wrote (not rebuilt: the word
        assignments stay those of the saved vocabulary), the vocabulary on
        this session's device.  False when there is no state file, or when
        the saved tree's checksum does not match its file."""
        fp = os.path.join(path, "loop_closing_state.npz")
        if not os.path.exists(fp):
            return False
        z = np.load(fp)
        self.reset()
        voc = self.detector.vocabulary
        voc_fp = os.path.join(path, "loop_vocabulary.npz")
        if os.path.exists(voc_fp):
            loaded = HierarchicalVocabulary.load(voc_fp, device=self.device)
            if "voc_checksum" in z and loaded.checksum() != str(z["voc_checksum"]):
                Printer.red("loop DB vocabulary checksum mismatch: stored word "
                            "assignments are inconsistent — rebuilding DB instead")
                return False
            self.detector.vocabulary = loaded
            self.detector._trained = True
        elif "voc_words_bits" in z:
            voc.words_bits = z["voc_words_bits"]
            voc._upload()
            voc.seeded = True
            voc.doc_count = int(z["voc_doc_count"])
            voc.word_doc_count = z["voc_word_doc_count"]
            self.detector._trained = True
        kids = z["kids"]
        gdes = z["gdes"]
        offs = z["word_offsets"]
        flat = z["words_flat"]
        kp_offs = z["kp_word_offsets"] if "kp_word_offsets" in z else None
        kp_flat = z["kp_words_flat"] if "kp_words_flat" in z else None
        for i, kid in enumerate(kids):
            # the full per-keypoint words (direct index) where saved, else
            # the unique word sets of an older save
            words = None
            if kp_offs is not None:
                kp = kp_flat[kp_offs[i]:kp_offs[i + 1]]
                if len(kp):
                    words = kp
            if words is None:
                w = flat[offs[i]:offs[i + 1]]
                words = w if len(w) else None
            self.db.add(int(kid), words, gdes[i])
        self.last_loop_kf_id = int(z["last_loop_kf_id"])
        self.num_loops_closed = int(z["num_loops_closed"])
        return True

    def add_keyframe(self, kf: KeyFrame):
        self.queue.append(kf)

    def step(self) -> bool:
        if not self.queue:
            return self.gba.poll()     # service a GBA in flight
        kf = self.queue.popleft()
        if kf.is_bad or kf.kid not in self.map.keyframes:
            return True
        with self.timings.stage("process_kf"):
            self.process_keyframe(kf)
        return True

    def finish(self):
        """Drain the detection queue and wait until a GBA in flight has
        been applied."""
        while self.queue:
            self.step()
        self.gba.finish()

    # ------------------------------------------------------------- detection
    def process_keyframe(self, kf: KeyFrame):
        words, g_des = self.detector.describe_frame(kf)
        kf.g_des = g_des
        # VLAD trains on the first keyframes of the session: once it fires,
        # re-describe every keyframe stored with the placeholder descriptor
        vlad = self.detector.vlad
        if vlad is not None and vlad.consume_just_trained():
            for kid2 in list(self.db.kf_gdes):
                kf2 = self.map.keyframes.get(kid2)
                if kf2 is not None:
                    g2 = vlad.global_descriptor(kf2.dev("des"), kf2.dev("valid"))
                    self.db.kf_gdes[kid2] = g2
                    kf2.g_des = g2
            kf.g_des = g_des = vlad.global_descriptor(kf.dev("des"), kf.dev("valid"))
        candidates: list[int] = []
        if (kf.kid - self.last_loop_kf_id >= Parameters.kLoopDetectionMinFramesAfterLastDetection
                and self.map.num_keyframes() > 10):
            # query-time idf from the vocabulary's current document statistics
            if words is not None:
                self.db.idf = self.detector.vocabulary.idf_weights()
            candidates = self.db.detect_loop_candidates(
                kf.kid, words, g_des, set(kf.connected_keyframes.keys()), self._covisibles)
        # register after querying (no self-hit)
        self.db.add(kf.kid, words, g_des)
        if words is not None:
            self.detector.vocabulary.add_document(words)
        if not candidates:
            self.consistency.check([], self._covisibles)
            return
        for cand_kid in self.consistency.check(candidates, self._covisibles):
            cand = self.map.keyframes.get(cand_kid)
            if cand is None or cand.is_bad:
                continue
            # temporal gate: a candidate a few keyframes old re-detects the
            # local neighbourhood, not a loop
            if kf.kid - cand_kid < Parameters.kLoopDetectionMinKeyframeDistance:
                continue
            with self.timings.stage("geometry_check"):
                ok, S12, matches = self.geometry_check(kf, cand)
            if ok:
                Printer.green(f"LOOP: kf {kf.kid} <-> kf {cand_kid} ({matches} matched points)")
                with self.timings.stage("correct_loop"):
                    self.correct_loop(kf, cand, S12)
                self.last_loop_kf_id = kf.kid
                self.num_loops_closed += 1
                self.consistency.reset()
                break

    def _covisibles(self, kid: int) -> list[int]:
        kf = self.map.keyframes.get(kid)
        return kf.ordered_covisibles(Parameters.kLoopClosingNumCovisiblesForCandidate) if kf else []

    # -------------------------------------------------------- geometry check
    def geometry_check(self, kf: KeyFrame, cand: KeyFrame):
        """Sim(3) RANSAC + refinement between the two keyframes' map points.
        Returns (ok, S12 mapping cand-camera to kf-camera coordinates,
        number of matches)."""
        st = self.map.points
        cam = self.camera
        g = self.last_geometry = {}
        slots1 = np.nonzero(kf.points >= 0)[0]
        if len(slots1) < 20:
            return False, None, 0
        pids1 = self.map.resolve_replacements(kf.points[slots1])
        a1 = (pids1 >= 0) & st.valid[np.clip(pids1, 0, None)]
        slots1, pids1 = slots1[a1], pids1[a1]

        # loop side: the candidate's covisible map in its camera frame, gated
        # to its frustum (uv2 by projection)
        pids2 = self.map.get_local_map_points([cand.kid] + cand.ordered_covisibles(10))
        if len(pids2) < 20:
            return False, None, 0
        p2_all = (cand.Tcw[:3, :3] @ st.pos[pids2].T).T + cand.Tcw[:3, 3]
        z2 = p2_all[:, 2]
        u2 = cam.fx * p2_all[:, 0] / np.maximum(z2, 1e-9) + cam.cx
        v2 = cam.fy * p2_all[:, 1] / np.maximum(z2, 1e-9) + cam.cy
        in_view = ((z2 > 0.1) & (u2 >= cam.u_min) & (u2 < cam.u_max)
                   & (v2 >= cam.v_min) & (v2 < cam.v_max))
        pids2 = pids2[in_view]
        if len(pids2) < 20:
            return False, None, 0

        # descriptor matching of the two point sets, gated to shared
        # direct-index subtrees when that leaves enough pairs
        d = hamming.descriptor_distance_matrix(self._put(st.desc[pids1], st.desc.dtype),
                                               self._put(st.desc[pids2], st.desc.dtype))
        voc = self.detector.vocabulary
        kp_words1 = self.db.kf_kp_words.get(kf.kid)
        idx = None
        if (hasattr(voc, "level_nodes_for") and kp_words1 is not None
                and len(kp_words1) > slots1.max(initial=0)):
            lvl = max(0, voc.depth - Parameters.kLoopClosingDirectIndexLevel)
            w2 = voc.words_for(st.desc[pids2], np.ones(len(pids2), bool))
            a = voc.level_nodes_for(kp_words1[slots1], lvl)
            b = voc.level_nodes_for(w2, lvl)
            mask = (a[:, None] == b[None, :]) & (a[:, None] >= 0)
            idx_g, _ = matching.match_ratio_test(
                d, Parameters.kMaxDescriptorDistance,
                ratio=Parameters.kLoopClosingFeatureMatchRatioTest,
                extra_mask=self._put(mask, bool))
            idx_g = idx_g.cpu().numpy()
            if (idx_g >= 0).sum() >= self.min_bow_matches:
                idx = idx_g
        if idx is None:
            idx, _ = matching.match_ratio_test(
                d, Parameters.kMaxDescriptorDistance,
                ratio=Parameters.kLoopClosingFeatureMatchRatioTest)
            idx = idx.cpu().numpy()
        rows = np.nonzero(idx >= 0)[0]
        g.update(points1=len(pids1), points2=len(pids2), bow_matches=len(rows))
        if len(rows) < self.min_bow_matches:
            return False, None, 0

        p1_c = (kf.Tcw[:3, :3] @ st.pos[pids1[rows]].T).T + kf.Tcw[:3, 3]
        p2_c = (cand.Tcw[:3, :3] @ st.pos[pids2[idx[rows]]].T).T + cand.Tcw[:3, 3]
        uv1 = kf.kps[slots1[rows]]
        zz = np.maximum(p2_c[:, 2], 1e-9)
        uv2 = np.stack([cam.fx * p2_c[:, 0] / zz + cam.cx, cam.fy * p2_c[:, 1] / zz + cam.cy], 1)
        sig1 = self.tracker.sigma2[kf.levels[slots1[rows]]]
        sig2 = np.ones(len(rows), np.float32)

        p1_p, valid = pad_bucket(p1_c.astype(np.float32))
        m = len(valid)
        fix_scale = self.sensor_type != SensorType.MONOCULAR
        # minimal sets weighted 1/max(z1, z2)^4 (inverse depth variance
        # squared): stereo depth error grows ~z^2, so triples of far points
        # give useless Umeyama solutions, while every point still votes
        zmax = np.maximum(np.maximum(p1_c[:, 2], p2_c[:, 2]), 0.5)
        w_near = (1.0 / zmax ** 4).astype(np.float32)
        valid_t = self._put(valid, bool)
        args = [self._put(pad_rows(x.astype(np.float32), m, fill=f))
                for x, f in ((p1_c, 0), (p2_c, 0), (uv1, 0), (uv2, 0), (sig1, 1.0), (sig2, 1.0))]
        n_hyp = Parameters.kSim3SolverRansacIterations
        w_t = self._put(pad_rows(w_near, m))
        S12, inl, n_inl = procrustes.sim3_ransac_reproj(
            *args, valid_t, self._K, self._K, num_hyp=n_hyp, with_scale=not fix_scale,
            sample_weights=w_t, samples=self.sampler(valid_t, n_hyp, 3, w_t))
        g["ransac_inliers"] = n_inl = int(n_inl)
        if n_inl < self.min_sim3_inliers:
            return False, None, 0
        S_opt, _, n_inl2 = optim.optimize_sim3(
            S12, *args, valid_t, self._K, self._K, chi2_th=Parameters.kLoopClosingTh2,
            fix_scale=fix_scale, inliers_init=inl)
        g["sim3_inliers"] = n_inl2 = int(n_inl2)
        if n_inl2 < self.min_sim3_inliers:
            return False, None, n_inl2
        S12_np = S_opt.cpu().numpy().astype(np.float64)

        # Sim(3)-guided enrichment before the final acceptance
        n_extra = self._search_by_sim3(kf, cand, S12_np)
        g["extra_matches"] = n_extra
        n_final = n_inl2 + n_extra
        if n_final < self.min_matched_points:
            return False, None, n_final
        return True, S12_np, n_final

    def _search_by_sim3(self, kf: KeyFrame, cand: KeyFrame, S12: np.ndarray) -> int:
        """Extra matches of the loop side's points projected through S12 into
        kf (the projection u = fx x / z does not see the scale)."""
        m = self.map
        st = m.points
        loop_pids = m.get_local_map_points([cand.kid] + cand.ordered_covisibles(10))
        own = set(int(p) for p in kf.points[kf.points >= 0])
        loop_pids = np.asarray([p for p in loop_pids if int(p) not in own], np.int64)
        if len(loop_pids) == 0:
            return 0
        Scw = S12 @ self._se3_to_S(cand.Tcw)        # world -> scaled cam-1 frame
        s_scale, R, t = self._S_to_srt(Scw)
        Ow = -R.T @ (t / s_scale)
        d = st.pos[loop_pids] - Ow[None, :]
        normals = (d / np.maximum(np.linalg.norm(d, axis=1)[:, None], 1e-9)).astype(np.float32)
        pos_p, valid_p = pad_bucket(st.pos[loop_pids])
        mm = len(valid_p)
        _, kp_match, _ = slam_matching.search_by_projection(
            self._put(pos_p), self._put(pad_rows(st.desc[loop_pids], mm), st.desc.dtype),
            self._put(pad_rows(normals, mm)), torch.zeros(mm, device=self.device),
            torch.full((mm,), 1e9, device=self.device), self._put(valid_p, bool),
            kf.dev("kps"), kf.dev("levels"), kf.dev("des"), kf.dev("valid"), kf.dev("kps_ur"),
            self._put(Scw), self._K, self._ib, self._sf, 7.5,
            float(Parameters.kMaxDescriptorDistance))
        kp_match = kp_match.cpu().numpy()
        return int(((kp_match >= 0) & (kp_match < len(loop_pids))).sum())

    # ------------------------------------------------------------ correction
    def correct_loop(self, kf: KeyFrame, cand: KeyFrame, S12: np.ndarray):
        """Propagate the Sim(3) correction and optimise the essential graph."""
        # drain local mapping first: an LBA applied after the propagation
        # would re-impose the pre-correction geometry
        if self.local_mapping is not None:
            self.local_mapping.finish()
        m = self.map
        st = m.points
        if not np.isfinite(S12).all():
            Printer.red("loop correction skipped: non-finite Sim3")
            return
        S_cur_corrected = S12 @ self._se3_to_S(cand.Tcw)
        group = [kf.kid] + [k for k in kf.ordered_covisibles() if k in m.keyframes]
        Twc_cur = kf.Twc
        S_old = {kid: self._se3_to_S(m.keyframes[kid].Tcw) for kid in m.keyframe_order}
        corrected: dict[int, np.ndarray] = {}
        for kid in group:
            corrected[kid] = self._se3_to_S(m.keyframes[kid].Tcw @ Twc_cur) @ S_cur_corrected

        # the group's points: p' = S_new^-1 (S_old p); each remembers the
        # keyframe that corrected it
        moved: dict[int, int] = {}
        for kid in group:
            kf_i = m.keyframes[kid]
            pids = kf_i.points[kf_i.points >= 0]
            pids = pids[st.valid[pids]]
            fresh = [int(p) for p in pids if int(p) not in moved]
            if not fresh:
                continue
            moved.update((p, kid) for p in fresh)
            fresh = np.asarray(fresh)
            st.pos[fresh] = self._sim3_apply(np.linalg.inv(corrected[kid]) @ S_old[kid],
                                             st.pos[fresh])
            m.store_version += 1
        # corrected poses, the scale folded into the translation
        for kid in group:
            m.keyframes[kid].update_pose(self._S_to_T(corrected[kid]))
        kf.loop_edges.add(cand.kid)
        cand.loop_edges.add(kf.kid)
        before = {kid: set(m.keyframes[kid].connected_keyframes) for kid in group}
        self._fuse_loop_points(kf, cand)
        # the loop connections: covisibility links that the fusion made
        # between the corrected group and the loop's side
        seam = {(min(a, b), max(a, b)) for a in group
                for b in m.keyframes[a].connected_keyframes
                if b not in before[a] and b not in corrected}
        with self.timings.stage("pgo"):
            self._essential_graph_pgo(kf, cand, S_old, corrected, seam, moved)
        # the polishing GBA runs as polled chunks while tracking goes on; it
        # supersedes a solve still in flight from an earlier loop
        self.gba.dispatch(m, iters=Parameters.kOptimizerGBAIterations)

    def _fuse_loop_points(self, kf: KeyFrame, cand: KeyFrame):
        m = self.map
        st = m.points
        loop_pids = m.get_local_map_points([cand.kid] + cand.ordered_covisibles(10))
        if len(loop_pids) == 0:
            return
        max_d = float(Parameters.kMaxDescriptorDistance) * 0.5
        for kid in [kf.kid] + kf.ordered_covisibles(10):
            kf_i = m.keyframes.get(kid)
            if kf_i is None:
                continue
            own = set(int(p) for p in kf_i.points[kf_i.points >= 0])
            cand_pids = np.asarray(
                [p for p in loop_pids if int(p) not in own and st.valid[int(p)]], np.int64)
            if len(cand_pids) == 0:
                continue
            pos_p, valid_p = pad_bucket(st.pos[cand_pids])
            mm = len(valid_p)
            best_kp, _ = slam_matching.fuse_candidates(
                self._put(pos_p)[None],
                self._put(pad_rows(st.desc[cand_pids], mm), st.desc.dtype)[None],
                self._put(pad_rows(st.normal[cand_pids], mm))[None],
                self._put(pad_rows(st.min_dist[cand_pids], mm))[None],
                self._put(pad_rows(st.max_dist[cand_pids], mm, fill=1.0))[None],
                self._put(valid_p, bool)[None], kf_i.dev("kps")[None],
                kf_i.dev("levels")[None], kf_i.dev("des")[None], kf_i.dev("valid")[None],
                kf_i.dev("kps_ur")[None], self._put(kf_i.Tcw)[None], self._K, self._bf,
                self._ib, self._sf, self._sigma2, max_d)
            best_kp = best_kp[0].cpu().numpy()[: len(cand_pids)]
            for row, kp_idx in enumerate(best_kp):
                if kp_idx < 0:
                    continue
                pid = int(cand_pids[row])
                existing = int(kf_i.points[kp_idx])
                if existing >= 0 and st.valid[existing]:
                    if existing != pid:
                        m.replace_point(existing, pid)   # the loop point wins
                else:
                    m.add_observation(pid, kf_i, int(kp_idx))
            m.update_connections(kf_i)

    def _essential_graph_pgo(self, kf, cand, S_old, corrected, seam, corrected_by):
        """Sim(3) PGO of the essential graph: spanning tree, loop edges and
        covisibility >= 100.  An edge inside the corrected group, the new
        loop edge and the loop connections ``seam`` (links the fusion made
        across the loop, ORB-SLAM's LoopConnections) are measured between
        the corrected poses; every other edge keeps its pre-correction
        relative pose.  The reference measures the loop connections before
        the correction too, which pulls the two sides of the loop back
        apart by the drift the loop removes.

        Each point then moves with its reference keyframe's change: the
        keyframe that corrected it (``corrected_by``, ORB-SLAM's
        mnCorrectedReference), else its oldest observer.  The reference
        takes the oldest observer for every point, so a group point that an
        older keyframe outside the group also sees is corrected twice."""
        m = self.map
        kids = list(m.keyframe_order)
        row = {kid: i for i, kid in enumerate(kids)}
        V = len(kids)
        S_init = np.stack([corrected.get(kid, self._se3_to_S(m.keyframes[kid].Tcw))
                           for kid in kids])
        edges = set()
        for kid in kids:
            kf_i = m.keyframes[kid]
            if kf_i.parent is not None and kf_i.parent in row:
                edges.add((min(kid, kf_i.parent), max(kid, kf_i.parent)))
            for le in kf_i.loop_edges:
                if le in row:
                    edges.add((min(kid, le), max(kid, le)))
            for nkid, w in kf_i.connected_keyframes.items():
                if w >= 100 and nkid in row:
                    edges.add((min(kid, nkid), max(kid, nkid)))
        edges = sorted(edges)
        self.last_pgo_size = (V, len(edges))
        if not edges:
            return
        ei = np.asarray([row[a] for a, _ in edges], np.int64)
        ej = np.asarray([row[b] for _, b in edges], np.int64)
        group = set(corrected.keys())
        S_meas = []
        for a, b in edges:
            if {a, b} == {kf.kid, cand.kid} or (a, b) in seam or (a in group and b in group):
                Sa, Sb = corrected.get(a, S_old[a]), corrected.get(b, S_old[b])
            else:
                Sa, Sb = S_old[a], S_old[b]
            S_meas.append(Sa @ np.linalg.inv(Sb))
        fixed = np.zeros(V, bool)
        fixed[row[cand.kid]] = True
        S_opt = optim.pose_graph_optimize(
            self._put(S_init), self._put(ei, np.int64), self._put(ej, np.int64),
            self._put(np.stack(S_meas)), torch.ones(len(edges), dtype=torch.bool,
                                                    device=self.device),
            self._put(fixed, bool), iters=Parameters.kOptimizerPGOIterations,
            fix_scale=self.sensor_type != SensorType.MONOCULAR).cpu().numpy()
        if not np.isfinite(S_opt).all():
            Printer.red("PGO diverged (non-finite poses): discarding correction")
            return

        # points move with their reference keyframe
        st = m.points
        by_kid: dict[int, list[int]] = {}
        for pid in st.alive_ids():
            ref = corrected_by.get(int(pid))
            if ref is None:
                obs = m.observations.get(int(pid))
                if not obs:
                    continue
                ref = min(obs.keys())
            by_kid.setdefault(ref, []).append(int(pid))
        for ref_kid, pids in by_kid.items():
            if ref_kid not in row:
                continue
            S_o = corrected.get(ref_kid, S_old.get(ref_kid))
            if S_o is None:
                continue
            pids = np.asarray(pids, np.int64)
            st.pos[pids] = self._sim3_apply(np.linalg.inv(S_opt[row[ref_kid]]) @ S_o,
                                            st.pos[pids])
        m.store_version += 1
        for kid in kids:
            m.keyframes[kid].update_pose(self._S_to_T(S_opt[row[kid]]))

    # --------------------------------------------------------------- helpers
    @staticmethod
    def _se3_to_S(T: np.ndarray) -> np.ndarray:
        return np.asarray(T, np.float64).copy()

    @staticmethod
    def _S_to_srt(S: np.ndarray):
        sR = S[:3, :3]
        s = np.cbrt(np.linalg.det(sR))
        return s, sR / s, S[:3, 3]

    @classmethod
    def _S_to_T(cls, S: np.ndarray) -> np.ndarray:
        """Sim(3) -> SE(3) with the scale folded into the translation."""
        s, R, t = cls._S_to_srt(S)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t / s
        return T

    @staticmethod
    def _sim3_apply(S: np.ndarray, pts: np.ndarray) -> np.ndarray:
        return pts @ S[:3, :3].T + S[:3, 3]
