"""PnP relocalisation of a lost frame (port of
``pyslam_tpu/loop_closing/relocalizer.py:21-178``).

For each candidate keyframe from the bag-of-words database (the five most
recent keyframes when it has none): Hamming matching of the frame against
the candidate's map points (gated to shared vocabulary subtrees by the
direct index when that leaves enough pairs), batched-hypothesis RANSAC PnP,
enrichment by projecting the candidate's covisible map into the frame, and
motion-only pose optimisation; the frame is relocalised when enough
inliers survive.
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.ops import hamming, matching, optim, pnp, slam_matching
from pyslam_tpu_torch.ops.epipolar import generator_sampler
from pyslam_tpu_torch.utils.padding import pad_bucket, pad_rows


class Relocalizer:
    """``sampler`` (optional) replaces the PnP RANSAC's minimal-sample draws,
    see ``ops.epipolar.generator_sampler``; by default they come from a
    ``torch.Generator`` seeded 7."""

    def __init__(self, camera, keyframe_db=None, detector=None, *,
                 device: torch.device | str = "cuda", sampler=None):
        self.camera = camera
        self.keyframe_db = keyframe_db
        self.detector = detector
        self.device = torch.device(device)
        self.sampler = sampler if sampler is not None else generator_sampler(self.device, 7)
        self._frame_words = None   # words of the frame being relocalised

    def _candidates(self, frame, slam_map) -> list[int]:
        self._frame_words = None
        if self.detector is not None and self.keyframe_db is not None:
            words, g_des = self.detector.describe_frame(frame)
            self._frame_words = words
            voc = getattr(self.detector, "vocabulary", None)
            if words is not None and voc is not None:
                self.keyframe_db.idf = voc.idf_weights()   # query-time tf-idf
            cands = self.keyframe_db.detect_relocalization_candidates(words, g_des)
            if cands:
                return cands
        return list(slam_map.keyframe_order[-5:])

    def _guided_mask(self, kid: int, kf_slots: np.ndarray):
        """Direct-index guided matching: the (P, N) pairs whose words share a
        vocabulary subtree at the direct-index level, or None without a tree
        vocabulary or stored keypoint words."""
        voc = getattr(self.detector, "vocabulary", None)
        db = self.keyframe_db
        fw = self._frame_words
        if voc is None or not hasattr(voc, "level_nodes_for") or db is None or fw is None:
            return None
        kp_words = db.kf_kp_words.get(kid)
        if kp_words is None or len(kp_words) <= kf_slots.max(initial=0):
            return None
        lvl = max(0, voc.depth - 3)
        a = voc.level_nodes_for(kp_words[kf_slots], lvl)
        b = voc.level_nodes_for(np.asarray(fw), lvl)
        return (a[:, None] == b[None, :]) & (a[:, None] >= 0)

    def relocalize(self, frame, slam_map):
        """Returns (Tcw, ok)."""
        cam = self.camera
        st = slam_map.points
        dev = self.device

        def put(x, dtype=np.float32):
            return torch.as_tensor(np.asarray(x, dtype)).to(dev)

        K = put(cam.K)
        for kid in self._candidates(frame, slam_map):
            kf = slam_map.keyframes.get(kid)
            if kf is None:
                continue
            kf_slots = np.nonzero(kf.points >= 0)[0]
            if len(kf_slots) < 15:
                continue
            pids = slam_map.resolve_replacements(kf.points[kf_slots])
            alive = (pids >= 0) & st.valid[np.clip(pids, 0, None)]
            kf_slots, pids = kf_slots[alive], pids[alive]
            if len(pids) < 15:
                continue

            d = hamming.hamming_distance_matrix(put(st.desc[pids], np.int8), frame.dev("des"))
            idx = None
            mask = self._guided_mask(kid, kf_slots)
            if mask is not None:
                idx, _ = matching.match_ratio_test(
                    d, Parameters.kMaxDescriptorDistance,
                    ratio=Parameters.kRelocalizationFeatureMatchRatioTest,
                    valid_b=frame.dev("valid"), extra_mask=put(mask, bool))
                idx = idx.cpu().numpy()
                if (idx >= 0).sum() < Parameters.kRelocalizationMinPnPInliers:
                    idx = None   # too sparse under guidance: match unguided
            if idx is None:
                idx, _ = matching.match_ratio_test(
                    d, Parameters.kMaxDescriptorDistance,
                    ratio=Parameters.kRelocalizationFeatureMatchRatioTest,
                    valid_b=frame.dev("valid"))
                idx = idx.cpu().numpy()
            rows = np.nonzero(idx >= 0)[0]
            if len(rows) < Parameters.kRelocalizationMinPnPInliers:
                continue
            kp_idx = idx[rows]
            p3d_p, valid = pad_bucket(st.pos[pids[rows]].astype(np.float32))
            xy_p = pad_rows(np.asarray(cam.unproject_points(frame.kps[kp_idx]), np.float32),
                            len(valid))
            valid_t = put(valid, bool)
            n_hyp = Parameters.kRelocalizationPnPRansacIterations
            T, inl_mask, n_inl = pnp.solve_pnp_ransac(
                put(p3d_p), put(xy_p), valid_t, 5.99 / cam.fx ** 2, n_hyp,
                samples=self.sampler(valid_t, n_hyp, 6, None))
            if int(n_inl) < Parameters.kRelocalizationMinPnPInliers:
                continue

            # refine + enrich: assign the PnP inliers to the frame, project the
            # candidate's covisible map into it, then motion-only optimisation
            frame.update_pose(T.cpu().numpy())
            frame.points[:] = -1
            inl = inl_mask.cpu().numpy()[: len(rows)]
            frame.points[kp_idx[inl]] = pids[rows[inl]]
            local = slam_map.get_local_map_points([kid] + kf.ordered_covisibles(10))
            if len(local) > 0:
                pos_p, valid_p = pad_bucket(st.pos[local])
                m = len(valid_p)
                _, kp_match, _ = slam_matching.search_by_projection(
                    put(pos_p), put(pad_rows(st.desc[local], m), np.int8),
                    put(pad_rows(st.normal[local], m)), put(pad_rows(st.min_dist[local], m)),
                    put(pad_rows(st.max_dist[local], m, fill=1.0)), put(valid_p, bool),
                    frame.dev("kps"), frame.dev("levels"), frame.dev("des"),
                    frame.dev("valid"), frame.dev("kps_ur"), put(frame.Tcw), K,
                    put([cam.u_min, cam.u_max, cam.v_min, cam.v_max]),
                    put(frame.feature_tracker.scale_factors),
                    float(Parameters.kMaxReprojectionDistanceMapRelocalize),
                    float(Parameters.kMaxOrbDistanceSearchByReproj))
                kp_match = kp_match.cpu().numpy()
                in_range = (kp_match >= 0) & (kp_match < len(local))
                new_kps = np.nonzero(in_range & (frame.points < 0))[0]
                frame.points[new_kps] = local[kp_match[new_kps]]

            slots = np.nonzero(frame.points >= 0)[0]
            if len(slots) < Parameters.kRelocalizationMinPnPInliers:
                continue
            pts3d, valid = pad_bucket(st.pos[frame.points[slots]].astype(np.float32))
            m = len(valid)
            T_opt, inliers, _ = optim.pose_optimization(
                put(frame.Tcw), put(pts3d), put(pad_rows(frame.kps[slots], m)),
                put(pad_rows(frame.kps_ur[slots], m, fill=-1.0)),
                put(pad_rows(frame.sigma2_for(slots), m, fill=1.0)), put(valid, bool), K,
                bf=cam.bf)
            inliers = inliers.cpu().numpy()[: len(slots)]
            if inliers.sum() >= Parameters.kRelocalizationFinalMinNumInliers * 0.5:
                T_opt = T_opt.cpu().numpy()
                frame.update_pose(T_opt)
                frame.points[slots[~inliers]] = -1
                return T_opt, True
        return frame.Tcw, False
