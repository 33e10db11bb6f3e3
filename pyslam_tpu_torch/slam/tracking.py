"""Tracking front-end: the per-frame state machine (port of the depth-1 path
of ``pyslam_tpu/slam/tracking.py``).

Per frame on the OK path:
  1. motion-model pose prediction;
  2. the fused device step (``ops/fused_tracking.py``): search by projection
     against the previous frame, pose optimisation #1, local-map search,
     pose optimisation #2 — one dispatch, one readback;
  3. when the fused step is weak or missing, the fallback chain: previous
     frame by projection (narrow, then wide radius), else a full descriptor
     match against the reference keyframe; pose optimisation; local map;
  4. keyframe decision and creation (stereo and RGBD: spawn close points).

A monocular frame is accepted at ``kNumMinInliersPoseOptimizationTrackFrame``
inliers after the local map, where stereo and RGBD need
``kNumMinInliersTrackLocalMap``.

The state machine is host Python; every numeric stage runs on the device of
the feature tracker.  Each frame is predicted from the previous frame
re-anchored to its reference keyframe (``_update_last_frame``, ORB-SLAM's
UpdateLastFrame: the one place the port's tracking departs from the
reference).  A lost frame is relocalised by the relocaliser that ``Slam``
sets from its loop closing; without one (no loop detector) it stays lost,
as in the reference.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.ops import hamming, matching, optim, slam_matching
from pyslam_tpu_torch.ops.fused_tracking import gather_store_rows, track_frame_fused_indexed
from pyslam_tpu_torch.slam.frame import Frame, KeyFrame
from pyslam_tpu_torch.slam.initializer import Initializer
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.slam.motion_model import MotionModel
from pyslam_tpu_torch.slam.slam_dynamic_config import SLAMDynamicConfig
from pyslam_tpu_torch.utils.logging import Printer
from pyslam_tpu_torch.utils.profiling import StageTimings


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3
    RELOCALIZE = 4
    INIT_RELOCALIZE = 5


def cap_select(ids: np.ndarray, cap: int, score: np.ndarray) -> np.ndarray:
    """Keep at most ``cap`` ids, the highest ``score`` first, in their
    original order (the reference's local-map truncation)."""
    ids = np.asarray(ids)
    if len(ids) <= cap:
        return ids
    keep = np.argpartition(-np.asarray(score), cap - 1)[:cap]
    return ids[np.sort(keep)]


class TrackingHistory:
    """Relative-pose history for the final trajectory."""

    def __init__(self):
        self.timestamps: list[float] = []
        self.relative_poses: list[np.ndarray] = []  # Tcr: frame rel. to ref KF
        self.ref_kids: list[int] = []
        self.states: list[TrackingState] = []

    def add(self, timestamp, Tcw, ref_kf: KeyFrame, state):
        self.timestamps.append(timestamp)
        self.relative_poses.append(np.asarray(Tcw) @ ref_kf.Twc)
        self.ref_kids.append(ref_kf.kid)
        self.states.append(state)

    def final_trajectory(self, slam_map: Map):
        """Absolute poses recomposed from the (optimised) keyframe poses."""
        out_t, out_Twc = [], []
        for ts, Tcr, kid, st in zip(self.timestamps, self.relative_poses, self.ref_kids,
                                    self.states):
            kf = slam_map.keyframes.get(kid)
            if kf is None or st != TrackingState.OK:
                continue
            out_t.append(ts)
            out_Twc.append(np.linalg.inv(Tcr @ kf.Tcw))
        return np.asarray(out_t), np.asarray(out_Twc)


class Tracking:
    def __init__(self, camera, feature_tracker, slam_map: Map,
                 sensor_type: SensorType = SensorType.STEREO, local_mapping=None):
        self.camera = camera
        self.tracker = feature_tracker
        self.device = feature_tracker.device
        self.map = slam_map
        self.sensor_type = sensor_type
        self.local_mapping = local_mapping
        self.state = TrackingState.NO_IMAGES_YET
        self.initializer = Initializer(sensor_type, feature_tracker.num_features,
                                       device=self.device)
        self.motion_model = MotionModel()
        self.history = TrackingHistory()
        self.f_prev: Frame | None = None
        self.kf_ref: KeyFrame | None = None
        self.num_inliers = 0
        self.num_lost_frames = 0
        self.last_kf_frame_id = -1
        self.relocalizer = None
        self.reset_requested = False
        # called once right after the fused dispatch, before its readback:
        # Slam uses it to start the next frame's extraction behind it
        self.on_fused_dispatched = None
        self.timings = StageTimings("tracking")
        self.dyn_config = SLAMDynamicConfig() if Parameters.kUseDynamicDesDistanceTh else None
        dev = self.device
        self._K = torch.as_tensor(camera.K, dtype=torch.float32).to(dev)
        self._ib = torch.tensor([camera.u_min, camera.u_max, camera.v_min, camera.v_max],
                                dtype=torch.float32, device=dev)
        self._sf = torch.as_tensor(feature_tracker.scale_factors).to(dev)
        self._sigma2 = torch.as_tensor(feature_tracker.sigma2, dtype=torch.float32).to(dev)
        self._bf = torch.tensor(camera.bf, dtype=torch.float32, device=dev)

    @property
    def desc_dist_th(self) -> float:
        if self.dyn_config is not None:
            return self.dyn_config.descriptor_distance_th
        return float(Parameters.kMaxOrbDistanceSearchByReproj)

    def _scalar(self, x) -> torch.Tensor:
        return torch.tensor(float(x), dtype=torch.float32, device=self.device)

    def _pose(self, T) -> torch.Tensor:
        return torch.as_tensor(np.asarray(T, np.float32)).to(self.device)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64)).to(self.device)

    # ------------------------------------------------------------ utilities
    def _assigned(self, frame: Frame):
        kp_idxs = np.nonzero(frame.points >= 0)[0]
        return frame.points[kp_idxs], kp_idxs

    def _alive(self, pids):
        pids = self.map.resolve_replacements(pids)
        return pids[(pids >= 0) & self.map.points.valid[np.clip(pids, 0, None)]]

    def _search(self, pids, f_cur: Frame, Tcw, radius, ratio):
        """search_by_projection of the store rows ``pids`` into f_cur;
        returns per-keypoint row into ``pids`` or -1 (host)."""
        _, kp_match, _ = slam_matching.search_by_projection(
            *gather_store_rows(self.map.device_store(), self._ids(pids)),
            f_cur.dev("kps"), f_cur.dev("levels"), f_cur.dev("des"), f_cur.dev("valid"),
            f_cur.dev("kps_ur"), self._pose(Tcw), self._K, self._ib, self._sf,
            float(radius), float(np.float32(self.desc_dist_th)), ratio=ratio)
        return kp_match.cpu().numpy()

    def _pose_optimize(self, frame: Frame, pids: np.ndarray, kp_idxs: np.ndarray) -> int:
        """Motion-only LM on the frame's current assignment; drops outliers."""
        st = self.map.points
        dev = self.device
        T_opt, inliers, _ = optim.pose_optimization(
            self._pose(frame.Tcw),
            torch.as_tensor(st.pos[pids].astype(np.float32)).to(dev),
            torch.as_tensor(frame.kps[kp_idxs]).to(dev),
            torch.as_tensor(frame.kps_ur[kp_idxs]).to(dev),
            torch.as_tensor(frame.sigma2_for(kp_idxs).astype(np.float32)).to(dev),
            torch.ones(len(pids), dtype=torch.bool, device=dev), self._K, bf=self._bf)
        T_opt = T_opt.cpu().numpy()
        if not np.isfinite(T_opt).all():
            return 0   # diverged: keep the predicted pose, report no inliers
        inliers = inliers.cpu().numpy()
        frame.update_pose(T_opt)
        frame.outliers[kp_idxs] = ~inliers
        frame.points[kp_idxs[~inliers]] = -1
        return int(inliers.sum())

    # ------------------------------------------------ track vs previous frame
    def track_previous_frame(self, f_prev: Frame, f_cur: Frame) -> int:
        """Project the previous frame's points with a widening radius."""
        pids_prev, _ = self._assigned(f_prev)
        if len(pids_prev) == 0:
            return 0
        pids_prev = self._alive(pids_prev)
        if len(pids_prev) == 0:
            return 0
        for radius in (Parameters.kMaxReprojectionDistanceFrame,
                       Parameters.kMaxReprojectionDistanceFrameWide):
            kp_match = self._search(pids_prev, f_cur, f_cur.Tcw, radius, 0.9)
            matched = np.nonzero(kp_match >= 0)[0]
            if len(matched) >= Parameters.kMinNumMatchedFeaturesSearchFrameByProjection:
                break
        f_cur.points[:] = -1
        f_cur.points[matched] = pids_prev[kp_match[matched]]
        return len(matched)

    # ---------------------------------------------- track vs reference keyframe
    def track_reference_frame(self, kf: KeyFrame, f_cur: Frame) -> int:
        """Full descriptor match against the reference keyframe, with the
        rotation-consistency filter, propagating its map points."""
        d = hamming.hamming_distance_matrix(kf.dev("des"), f_cur.dev("des"))
        kf_has_point = torch.as_tensor((kf.points >= 0) & kf.valid).to(self.device)
        idx2, _ = matching.match_ratio_test(
            d, Parameters.kMaxDescriptorDistance, ratio=0.7, valid_a=kf_has_point,
            valid_b=f_cur.dev("valid"))
        idx2 = idx2.cpu().numpy()
        i_kf = np.nonzero(idx2 >= 0)[0]
        i_cur = idx2[i_kf]
        if Parameters.kCheckOrientation and len(i_kf) > 0:
            keep = matching.rotation_histogram_filter(
                torch.as_tensor(kf.angles[i_kf]), torch.as_tensor(f_cur.angles[i_cur]),
                torch.ones(len(i_kf), dtype=torch.bool)).numpy()
            i_kf, i_cur = i_kf[keep], i_cur[keep]
        pids = self.map.resolve_replacements(kf.points[i_kf])
        alive = (pids >= 0) & self.map.points.valid[np.clip(pids, 0, None)]
        f_cur.points[:] = -1
        f_cur.points[i_cur[alive]] = pids[alive]
        f_cur.update_pose(self.f_prev.Tcw if self.f_prev is not None else kf.Tcw)
        return int(alive.sum())

    # --------------------------------------------------------- track local map
    def _local_map_pids(self, count_visible: bool = True):
        st = self.map.points
        kids = self.map.get_local_keyframes(self.kf_ref)
        local_pids = self.map.get_local_map_points(kids)
        if len(local_pids) == 0:
            return None
        local_pids = cap_select(local_pids, Parameters.kTrackLocalMapMaxPoints,
                                score=st.num_obs[local_pids])
        if count_visible:
            st.n_visible[local_pids] += 1
        return local_pids

    def track_local_map(self, f_cur: Frame) -> int:
        if self.kf_ref is None:
            return 0
        local_pids = self._local_map_pids()
        if local_pids is None:
            return 0
        st = self.map.points
        kp_match = self._search(local_pids, f_cur, f_cur.Tcw,
                                Parameters.kMaxReprojectionDistanceMap,
                                Parameters.kMatchRatioTestMap)
        new_kps = np.nonzero((kp_match >= 0) & (f_cur.points < 0))[0]
        f_cur.points[new_kps] = local_pids[kp_match[new_kps]]
        pids, kp_idxs = self._assigned(f_cur)
        if len(pids) < Parameters.kMinTrackedFeaturesForPoseOpt:
            return 0
        n_inl = self._pose_optimize(f_cur, pids, kp_idxs)
        good_pids, good_kps = self._assigned(f_cur)
        st.n_found[good_pids] += 1
        if self.dyn_config is not None and len(good_pids) >= 10:
            from pyslam_tpu_torch.slam.slam_dynamic_config import hamming_rows

            self.dyn_config.update_descriptor_stats(
                hamming_rows(st.desc[good_pids], f_cur.des[good_kps]))
        return n_inl

    # ------------------------------------------------------ fused OK path
    def _fused_dispatch(self, f_prev: Frame, f_cur: Frame):
        """Launch the fused step from f_prev's assignments; returns the
        device result, or None when its prerequisites are missing."""
        pids_prev, _ = self._assigned(f_prev)
        if len(pids_prev) == 0 or self.kf_ref is None:
            return None
        pids_prev = self._alive(pids_prev)
        local_pids = self._local_map_pids()
        if len(pids_prev) < 10 or local_pids is None:
            return None
        return track_frame_fused_indexed(
            f_cur.dev("kps"), f_cur.dev("levels"), f_cur.dev("des"), f_cur.dev("valid"),
            f_cur.dev("kps_ur"), self.map.device_store(), self._ids(pids_prev),
            self._ids(local_pids),
            self._pose(f_cur.Tcw), self._K, self._ib, self._sf, self._sigma2, self._bf,
            self._scalar(Parameters.kMaxReprojectionDistanceFrame),
            self._scalar(Parameters.kMaxReprojectionDistanceFrameWide),
            self._scalar(Parameters.kMaxReprojectionDistanceMap),
            self._scalar(self.desc_dist_th), self._scalar(Parameters.kMatchRatioTestMap),
            min_prev_matches=Parameters.kMinNumMatchedFeaturesSearchFrameByProjection)

    def _fused_harvest(self, f_cur: Frame, res):
        """Read the fused result back and apply it to f_cur.  Returns
        (n_prev, n_inl1, n_inl2), or None when the pose diverged."""
        T2 = res.Tcw.cpu().numpy().astype(np.float64)
        n_prev, n_inl1, n_inl2 = (int(x) for x in res.counts.cpu().numpy())
        if not np.isfinite(T2).all():
            return None
        st = self.map.points
        pid_rows = res.match.cpu().numpy()
        inlier = res.inlier.cpu().numpy()
        match_dist = res.match_dist.cpu().numpy()
        f_cur.points[:] = -1
        # re-check liveness: a row can be culled between dispatch and harvest
        ok = (pid_rows >= 0) & st.valid[np.clip(pid_rows, 0, None)]
        f_cur.points[ok] = pid_rows[ok]
        f_cur.outliers[:] = False
        f_cur.outliers[ok & ~inlier] = True
        f_cur.points[ok & ~inlier] = -1
        f_cur.update_pose(T2)
        good_pids, _ = self._assigned(f_cur)
        st.n_found[good_pids] += 1
        if self.dyn_config is not None:
            self.dyn_config.update_descriptor_stats(match_dist[ok & inlier])
        return n_prev, n_inl1, n_inl2

    def track_fused(self, f_prev: Frame, f_cur: Frame):
        res = self._fused_dispatch(f_prev, f_cur)
        if res is None:
            return None
        if self.on_fused_dispatched is not None:
            cb, self.on_fused_dispatched = self.on_fused_dispatched, None
            cb()
        return self._fused_harvest(f_cur, res)

    # ----------------------------------------------------- keyframe decision
    def need_new_keyframe(self, f_cur: Frame) -> bool:
        """ORB-SLAM-style conditions (reference tracking need_new_keyframe)."""
        if self.kf_ref is None:
            return False
        num_kfs = self.map.num_keyframes()
        frames_since_kf = f_cur.id - self.last_kf_frame_id
        min_obs = 3 if num_kfs > 2 else 2
        ref_pids = self.kf_ref.points[self.kf_ref.points >= 0]
        ref_matches = int((self.map.points.num_obs[ref_pids] >= min_obs).sum()) \
            if len(ref_pids) else 0
        # right after stereo init every point has ONE observation: fall back
        # to the raw association count so the second keyframe can spawn
        if ref_matches == 0:
            ref_matches = len(ref_pids)
        is_stereo = self.sensor_type in (SensorType.STEREO, SensorType.RGBD)
        feat_scale = self.tracker.num_features / 2000.0
        n_tracked_close = n_nontracked_close = 0
        if is_stereo:
            close = (f_cur.depths > 0) & (f_cur.depths < self.camera.depth_threshold)
            tracked = (f_cur.points >= 0) & ~f_cur.outliers
            n_tracked_close = int((close & tracked).sum())
            n_nontracked_close = int((close & ~tracked).sum())
        need_close = is_stereo and (
            n_tracked_close
            < Parameters.kNumMinTrackedClosePointsForNewKfNonMonocular * feat_scale
            and n_nontracked_close
            > Parameters.kNumMaxNonTrackedClosePointsForNewKfNonMonocular * feat_scale)
        th_ratio = (Parameters.kThNewKfRefRatioStereo if is_stereo
                    else Parameters.kThNewKfRefRatio)
        if num_kfs < 3:
            th_ratio = 0.4
        idle = self._local_mapping_idle()
        cond1a = frames_since_kf >= Parameters.kNumMaxFramesBetweenKfs
        cond1b = frames_since_kf >= Parameters.kNumMinFramesBetweenKfs and idle
        cond1c = is_stereo and (
            self.num_inliers < ref_matches * Parameters.kThNewKfRefRatioNonMonocular
            or need_close)
        cond2 = (self.num_inliers < ref_matches * th_ratio or need_close) \
            and self.num_inliers > Parameters.kNumMinPointsForNewKf
        if Parameters.kLogKeyFrameDecision:
            Printer.gray(
                f"[kf?] f={f_cur.id} inl={self.num_inliers} ref={ref_matches} "
                f"close(t/nt)={n_tracked_close}/{n_nontracked_close} "
                f"need_close={need_close} 1a={cond1a} 1b={cond1b}(idle={idle}) "
                f"1c={cond1c} 2={cond2} since={frames_since_kf}")
        if not ((cond1a or cond1b or cond1c) and cond2):
            return False
        if idle:
            return True
        # back-end busy: interrupt its LBA and insert anyway while the queue
        # is short (stereo keyframes must not wait for the back-end)
        if self.local_mapping is not None:
            self.local_mapping.interrupt_optimization()
            return self.local_mapping.queue_size() < 3
        return False

    def _local_mapping_idle(self) -> bool:
        lm = self.local_mapping
        return lm is None or lm.accepts_keyframes()

    def create_new_keyframe(self, f_cur: Frame) -> KeyFrame:
        kf = KeyFrame(f_cur)
        pids, kp_idxs = self._assigned(f_cur)
        self.map.add_keyframe(kf)
        for pid, ki in zip(pids, kp_idxs):
            self.map.add_observation(int(pid), kf, int(ki))
        if self.sensor_type in (SensorType.STEREO, SensorType.RGBD):
            close = ((f_cur.depths > 0)
                     & (f_cur.depths < self.camera.depth_threshold * 2.0)
                     & (kf.points < 0) & kf.valid)
            idxs = np.nonzero(close)[0]
            if len(idxs) > 0:
                idxs = idxs[np.argsort(f_cur.depths[idxs])]
                pts_w, _ = kf.unproject_keypoints(idxs)
                self.map.add_points_for_keyframe(kf, idxs, pts_w)
        self.map.update_connections(kf)
        self.kf_ref = kf
        self.last_kf_frame_id = f_cur.id
        if self.local_mapping is not None:
            self.local_mapping.push_keyframe(kf)
        return kf

    # ----------------------------------------------------------------- track
    def track(self, img, img_right=None, depth=None, frame_id=0, timestamp=0.0,
              frame: Frame | None = None) -> Frame:
        with self.timings.stage("frame"):
            f_cur = frame if frame is not None else Frame(
                self.camera, img, img_right=img_right, depth=depth, timestamp=timestamp,
                feature_tracker=self.tracker, frame_id=frame_id)
        if self.state == TrackingState.NO_IMAGES_YET:
            self.state = TrackingState.NOT_INITIALIZED
        if self.state == TrackingState.NOT_INITIALIZED:
            out = self.initializer.initialize(f_cur, self.map, self.tracker)
            if out.success:
                self.state = TrackingState.OK
                self.kf_ref = out.kf_cur
                self.f_prev = f_cur
                self.last_kf_frame_id = f_cur.id
                self.motion_model.update(f_cur.Tcw, timestamp)
                self.history.add(timestamp, f_cur.Tcw, self.kf_ref, TrackingState.OK)
                if self.local_mapping is not None:
                    self.local_mapping.push_keyframe(out.kf_cur)
            return f_cur
        return self._track_core(f_cur, frame_id, timestamp)

    def _predict(self) -> np.ndarray:
        if Parameters.kUseMotionModel and self.motion_model.is_ok:
            return self.motion_model.predict(self.f_prev.Tcw)
        return self.f_prev.Tcw

    def _local_map_ok(self, n_inl: int) -> bool:
        """Enough inliers after the local map: monocular frames need only the
        frame-tracking minimum."""
        return n_inl >= Parameters.kNumMinInliersTrackLocalMap or (
            self.sensor_type == SensorType.MONOCULAR
            and n_inl >= Parameters.kNumMinInliersPoseOptimizationTrackFrame)

    def _track_core(self, f_cur: Frame, frame_id, timestamp) -> Frame:
        """OK/LOST state logic for one frame."""
        fused_ok = False
        if self.state == TrackingState.OK:
            self._update_last_frame()
            f_cur.update_pose(self._predict())
            out = None
            if (Parameters.kUseFusedTrackingStep and Parameters.kUseSearchFrameByProjection
                    and self.motion_model.is_ok):
                with self.timings.stage("track_fused"):
                    out = self.track_fused(self.f_prev, f_cur)
            if out is not None:
                n_inl2 = out[2]
                if self._local_map_ok(n_inl2):
                    self.num_inliers = n_inl2
                    fused_ok = True
                else:
                    # weak fused result: restore the prediction, run the chain
                    f_cur.points[:] = -1
                    f_cur.outliers[:] = False
                    f_cur.update_pose(self._predict())
            if not fused_ok:
                n_matched = 0
                with self.timings.stage("track_prev"):
                    if Parameters.kUseSearchFrameByProjection and self.motion_model.is_ok:
                        n_matched = self.track_previous_frame(self.f_prev, f_cur)
                    if n_matched < Parameters.kMinNumMatchedFeaturesSearchFrameByProjection:
                        n_matched = self.track_reference_frame(self.kf_ref, f_cur)
                with self.timings.stage("pose_opt"):
                    pids, kp_idxs = self._assigned(f_cur)
                    if len(pids) >= Parameters.kMinTrackedFeaturesForPoseOpt:
                        self.num_inliers = self._pose_optimize(f_cur, pids, kp_idxs)
                    else:
                        self.num_inliers = 0
                if self.num_inliers < Parameters.kNumMinInliersPoseOptimizationTrackFrame:
                    Printer.red(f"tracking failure on frame {frame_id} "
                                f"(inliers={self.num_inliers})")
                    self.state = TrackingState.LOST

        if self.state in (TrackingState.LOST, TrackingState.RELOCALIZE,
                          TrackingState.INIT_RELOCALIZE):
            if self._relocalize(f_cur):
                Printer.green(f"relocalized at frame {frame_id}")
                self.state = TrackingState.OK
                self.motion_model.reset()
            else:
                self.num_lost_frames += 1
                if (self.num_lost_frames > Parameters.kMaxLostFramesBeforeReset
                        and self.map.num_keyframes() <= 5
                        and self.state != TrackingState.INIT_RELOCALIZE):
                    Printer.yellow("tracking lost early: requesting reset")
                    self.reset_requested = True
                self.f_prev = f_cur
                return f_cur

        if not fused_ok:
            with self.timings.stage("track_local_map"):
                n_inl = self.track_local_map(f_cur)
            if self._local_map_ok(n_inl):
                self.num_inliers = n_inl
                self.state = TrackingState.OK
            elif self.num_inliers < Parameters.kNumMinInliersPoseOptimizationTrackFrame:
                self.state = TrackingState.LOST

        if self.state == TrackingState.OK:
            self.motion_model.update(f_cur.Tcw, timestamp)
            with self.timings.stage("kf_decision"):
                if self.need_new_keyframe(f_cur):
                    self.create_new_keyframe(f_cur)
            self.history.add(timestamp, f_cur.Tcw, self.kf_ref, TrackingState.OK)
            self.num_lost_frames = 0
        self.f_prev = f_cur
        return f_cur

    def _update_last_frame(self):
        """Re-anchor the previous frame to its reference keyframe (ORB-SLAM's
        UpdateLastFrame): its pose, and the motion model's last pose, keep
        the pose relative to that keyframe they had when it was tracked,
        wherever local BA, a loop correction or a GBA has moved the keyframe
        since.  The reference predicts from the stale pose; after a loop
        correction (metres) and the local BA that follows it that loses
        tracking (ROADMAP.md section 3)."""
        h = self.history
        if self.f_prev is None or not h.timestamps or h.timestamps[-1] != self.f_prev.timestamp:
            return
        kf = self.map.keyframes.get(h.ref_kids[-1])
        if kf is None:
            return
        T = h.relative_poses[-1] @ kf.Tcw
        self.f_prev.update_pose(T)
        if self.motion_model._last_Tcw is not None:
            self.motion_model._last_Tcw = T.copy()

    def _relocalize(self, f_cur: Frame) -> bool:
        if self.relocalizer is None:
            return False
        T, ok = self.relocalizer.relocalize(f_cur, self.map)
        if ok:
            f_cur.update_pose(T)
        return ok
