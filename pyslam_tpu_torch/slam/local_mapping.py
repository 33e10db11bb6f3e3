"""Local mapping back-end (port of ``pyslam_tpu/slam/local_mapping.py``).

Per new keyframe: associate and refresh its map points -> cull recent
points -> triangulate new points against covisible neighbours (epipolar-
gated matching on the device, DLT on the host) -> fuse duplicates -> local
bundle adjustment over the covisibility window -> cull redundant keyframes
-> hand the keyframe to loop closing, the semantic mapper and the
volumetric integrator, where they are attached.  With
``Parameters.kUseSemanticsInOptimization`` and a semantic mapper, the local
BA scales each observation's information by its keypoint's class weight
(``sigma2 / w``) once any keyframe of the window is labelled.

Scheduling: one host thread.  Each tracked frame advances the back-end by
bounded slices (``step_async``); device stages are dispatched and their
results polled, never awaited: a CUDA event recorded after each dispatch is
queried.  On a CUDA device the host slices run under a wall-clock budget
per frame; on the CPU they are counted (one full job per frame), which keeps
the keyframe cadence, and through it the result, independent of machine
load.  On the CPU the readiness of a dispatched result follows a
deterministic model of the reference's asynchronous CPU dispatch
(``Pending``), so that its jobs span frames as the reference's do and a
keyframe meets the same busy back-end.  The local BA runs in chunks of LM
iterations; a keyframe pushed while one is in flight aborts it after the
current chunk.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.ops import geometry, optim, slam_matching
from pyslam_tpu_torch.slam.frame import KeyFrame
from pyslam_tpu_torch.slam.kf_device_store import KFDeviceStore
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.slam.tracking import cap_select
from pyslam_tpu_torch.utils.logging import Printer
from pyslam_tpu_torch.utils.profiling import StageTimings


class Pending:
    """Device results of a dispatch plus a readiness probe: on a CUDA device
    an event recorded right after the dispatch.

    On the CPU the work is done by the time the dispatch returns, while the
    reference's CPU dispatch is asynchronous and polled
    (``jax.Array.is_ready``), so its back-end jobs span frames.  A
    deterministic model of it stands in, fitted to the reference's traced
    polls: a result is ready from the next back-end call on (``advance``,
    at each ``LocalMapping.step_async``: the next frame's harvest or its
    end-of-frame step), except that a ``long`` one (the triangulation's
    epipolar match against every neighbour) is ready only once a frame has
    been tracked since its dispatch, at an end-of-frame step."""

    _calls = 0    # back-end calls so far
    _frames = 0   # end-of-frame back-end steps so far

    def __init__(self, value, device: torch.device, long: bool = False):
        self.value = value
        self.event = None
        self.long = long
        self.tick = (Pending._calls, Pending._frames)
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    @classmethod
    def advance(cls, end_of_frame: bool):
        cls._calls += 1
        cls._frames += int(end_of_frame)

    def ready(self) -> bool:
        if self.event is not None:
            return self.event.query()
        if self.long:
            return Pending._frames > self.tick[1]
        return Pending._calls > self.tick[0]

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


class LocalMapping:
    # job slices: 0 associate + cull points, 1 triangulation dispatch,
    # 2 triangulation harvest (polled), 3 fuse dispatch, 4 fuse harvest
    # (polled), 5 LBA dispatch, 6 cull keyframes + hand-off
    _N_SLICES = 7

    def __init__(self, slam_map: Map, camera, sensor_type: SensorType, feature_tracker):
        self.map = slam_map
        self.camera = camera
        self.sensor_type = sensor_type
        self.tracker = feature_tracker
        self.device = feature_tracker.device
        self.queue: deque[KeyFrame] = deque()
        self.recent_pids: list[int] = []
        self.kf_cur: KeyFrame | None = None
        self.opt_abort_flag = False
        self._job: KeyFrame | None = None
        self._job_stage = 0
        self._tri_job: dict | None = None
        self._fuse_job: dict | None = None
        self._lba: dict | None = None
        self.lba_applied = 0
        self._kf_count = 0            # keyframes handed off (large-BA cadence)
        self._next_large_ba = 0       # the keyframe count that lets the next one in
        self.volumetric_integrator = None   # attached by Slam.set_volumetric_integrator
        self.loop_closing = None            # attached by Slam
        self.semantic_mapping = None        # attached by Slam.set_semantic_mapping
        self.timings = StageTimings("local_mapping")
        self._kf_store: KFDeviceStore | None = None
        dev = self.device
        self._K = torch.as_tensor(camera.K, dtype=torch.float32).to(dev)
        self._bf = torch.tensor(camera.bf, dtype=torch.float32, device=dev)
        self._ib = torch.tensor([camera.u_min, camera.u_max, camera.v_min, camera.v_max],
                                dtype=torch.float32, device=dev)
        self._sf = torch.as_tensor(feature_tracker.scale_factors).to(dev)
        self._sigma2 = torch.as_tensor(feature_tracker.sigma2, dtype=torch.float32).to(dev)

    def _kf_rows(self, kfs) -> torch.Tensor:
        kf0 = kfs[0]
        ks = self._kf_store
        if ks is None:
            des = kf0.dev("des")
            self._kf_store = ks = KFDeviceStore(32, kf0.num_kps, des.shape[1], self.device,
                                                desc_dtype=des.dtype)
        return torch.as_tensor(ks.rows_for(kfs)).to(self.device)

    # --------------------------------------------------------------- queue
    def push_keyframe(self, kf: KeyFrame):
        # a newly pending keyframe aborts the in-flight LBA after its chunk
        if self._lba is not None:
            self.opt_abort_flag = True
        self.queue.append(kf)

    def accepts_keyframes(self) -> bool:
        """Whether a new keyframe can be digested promptly: an in-flight LBA
        does not count as busy (a new keyframe aborts it), nor does a job
        whose triangulation has landed (stage >= 3).  Monocular: only when
        idle, so that every keyframe's LBA lands un-aborted (the scale
        drifts otherwise)."""
        if self.sensor_type == SensorType.MONOCULAR:
            return len(self.queue) == 0 and self._job is None
        return len(self.queue) == 0 and (self._job is None or self._job_stage >= 3)

    def queue_size(self) -> int:
        return len(self.queue)

    def interrupt_optimization(self):
        self.opt_abort_flag = True

    # ------------------------------------------------------- async schedule
    def step_async(self, start_new_jobs: bool = True) -> bool:
        """Advance the back-end once per tracked frame without waiting on
        the device.  The first slice always runs; further slices run while
        under budget (wall clock on CUDA, one full job on the CPU)."""
        Pending.advance(end_of_frame=start_new_jobs)
        did = False
        t0 = time.perf_counter()
        budget = Parameters.kLocalMappingHostBudgetMs * 1e-3
        wall_budget = self.device.type == "cuda"
        max_slices = 1 if budget <= 0 else self._N_SLICES
        n_slices = 0
        for _ in range(64):
            if self._lba is not None and self._lba_poll(block=False):
                did = True
                continue
            if self._job is None:
                if not self.queue or not start_new_jobs:
                    break
                self._job = self.queue.popleft()
                self._job_stage = 0
                self.kf_cur = self._job
            over = ((time.perf_counter() - t0 > budget) if wall_budget
                    else n_slices >= max_slices)
            # the triangulation dispatch is budget-exempt: deferring it
            # delays the keyframe's new points when tracking needs them
            if did and over and self._job_stage != 1:
                break
            # while the map is tiny run the job synchronously
            bootstrap = self.map.num_keyframes() <= 4
            if not self._advance_slice(block=bootstrap):
                break
            n_slices += 1
            did = True
        return did

    def harvest(self) -> bool:
        """Apply results that are already ready; never starts a new job."""
        return self.step_async(start_new_jobs=False)

    def _advance_slice(self, block: bool = False) -> bool:
        kf = self._job
        t = self.timings
        s = self._job_stage
        if s == 0:
            with t.stage("process_kf"):
                self.process_new_keyframe(kf)
            with t.stage("cull_points"):
                self.cull_map_points()
        elif s == 1:
            with t.stage("tri_dispatch"):
                self._tri_job = self._tri_dispatch(kf)
            self._job_stage = 2 if self._tri_job is not None else 3
            return True
        elif s == 2:
            job = self._tri_job
            if block:
                job["pending"].wait()
            elif not job["pending"].ready():
                return False
            with t.stage("triangulate"):
                self._tri_job = None
                self._tri_harvest(kf, job)
        elif s == 3:
            with t.stage("fuse_dispatch"):
                self._fuse_job = self._fuse_dispatch(kf)
            self._job_stage = 4 if self._fuse_job is not None else 5
            return True
        elif s == 4:
            job = self._fuse_job
            if block:
                job["pending"].wait()
            elif not job["pending"].ready():
                return False
            with t.stage("fuse"):
                self._fuse_job = None
                self._fuse_harvest(kf, job)
        elif s == 5:
            if self._lba is not None:
                if not block:
                    return False
                while self._lba is not None:
                    self._lba_poll(block=True)
            if self.map.num_keyframes() > 2:
                with t.stage("lba_dispatch"):
                    self._lba_dispatch(kf)
            self._job_stage = 6
            return True
        else:
            with t.stage("cull_kfs"):
                self.cull_keyframes(kf)
            self._trim_device_caches(kf)
            if self.loop_closing is not None:
                self.loop_closing.add_keyframe(kf)
            if self.semantic_mapping is not None:
                self.semantic_mapping.add_keyframe(kf)
            if self.volumetric_integrator is not None:
                self.volumetric_integrator.add_keyframe(kf)
            self._job = None
            # the periodic large-window BA (the reference's own thread every
            # kEveryNumFramesLargeWindowBA keyframes) goes through the LBA
            # slot and is polled like any chunk; a busy slot at the
            # threshold defers it to the next idle hand-off, never skips it
            self._kf_count += 1
            if self._next_large_ba == 0:
                self._next_large_ba = Parameters.kEveryNumFramesLargeWindowBA
            if (Parameters.kUseLargeWindowBA and self._lba is None and not self.queue
                    and self._kf_count >= self._next_large_ba
                    and self.map.num_keyframes() > 4):
                self._next_large_ba = self._kf_count + Parameters.kEveryNumFramesLargeWindowBA
                with t.stage("large_ba_dispatch"):
                    self._lba_dispatch(kf, window_size=Parameters.kLargeBAWindowSize)
            return True
        self._job_stage = s + 1
        return True

    def _trim_device_caches(self, kf: KeyFrame):
        """Free the device tensors of keyframes outside the new keyframe's
        covisibility neighbourhood (``Frame.dev`` re-uploads on next use)."""
        keep = set(kf.ordered_covisibles(Parameters.kLocalBAWindowSize))
        keep.add(kf.kid)
        keep.update(self.map.keyframe_order[-4:])
        for kid in self.map.keyframe_order:
            if kid not in keep:
                other = self.map.keyframes.get(kid)
                if other is not None and other._dev:
                    other.drop_device_cache()

    def finish(self):
        """Drain the back-end completely (blocking)."""
        while self._job is not None or self.queue or self._lba is not None:
            if self._job is None and self._lba is None:
                self._job = self.queue.popleft()
                self._job_stage = 0
                self.kf_cur = self._job
            while self._job is not None or self._lba is not None:
                if self._lba is not None:
                    self._lba_poll(block=True)
                else:
                    self._advance_slice(block=True)

    # ------------------------------------------------- process_new_keyframe
    def process_new_keyframe(self, kf: KeyFrame):
        """Associate tracked points, refresh normals/descriptors."""
        pids = kf.points[kf.points >= 0]
        for pid, ki in zip(pids, np.nonzero(kf.points >= 0)[0]):
            self.map.add_observation(int(pid), kf, int(ki))
        self.map.update_point_descriptors_and_normals(np.unique(pids))
        self.map.update_connections(kf)
        fresh = pids[self.map.points.first_kid[pids] >= kf.kid - 2]
        self.recent_pids = list(np.unique(np.concatenate([
            np.asarray(self.recent_pids, np.int64), fresh])))

    def cull_map_points(self):
        """Found-ratio and observation-count culling of recent points."""
        if not self.recent_pids or self.kf_cur is None:
            return
        st = self.map.points
        keep = []
        for pid in self.recent_pids:
            if not st.valid[pid]:
                continue
            found_ratio = st.n_found[pid] / max(st.n_visible[pid], 1)
            age = self.kf_cur.kid - st.first_kid[pid]
            if found_ratio < Parameters.kMapPointCullingMinFoundRatio:
                self.map.delete_point(pid)
            elif age >= 2 and st.num_obs[pid] <= 2:
                self.map.delete_point(pid)
            elif age >= 3:
                pass  # survived probation
            else:
                keep.append(pid)
        self.recent_pids = keep

    # ------------------------------------------------- new map points
    def _tri_dispatch(self, kf: KeyFrame):
        """Epipolar matching of kf against its covisible neighbours, all in
        one batched device call (dispatch half; DLT at harvest)."""
        mono = self.sensor_type == SensorType.MONOCULAR
        n_neighbors = (Parameters.kLocalMappingNumNeighborKeyFramesMonocular if mono
                       else Parameters.kLocalMappingNumNeighborKeyFramesStereo)
        cam = self.camera
        neighbors = []   # (kf2, F_21, epipole2)
        for kid2 in kf.ordered_covisibles(n_neighbors):
            kf2 = self.map.keyframes.get(kid2)
            if kf2 is None or kf2.is_bad:
                continue
            baseline = np.linalg.norm(kf2.Ow - kf.Ow)
            if mono:
                # baseline against kf2's median scene depth
                pids2 = kf2.points[kf2.points >= 0]
                med_depth = 1.0
                if len(pids2) > 0:
                    pc = (kf2.Tcw[:3, :3] @ self.map.points.pos[pids2].T).T + kf2.Tcw[:3, 3]
                    med_depth = np.median(pc[:, 2])
                if baseline / max(med_depth, 1e-6) < Parameters.kMinRatioBaselineDepth:
                    continue
            elif baseline < cam.b:
                continue   # baseline too small
            T21 = kf2.Tcw @ np.linalg.inv(kf.Tcw)
            F = geometry.fundamental_np(T21, cam.K, cam.K).astype(np.float32)
            c1_in_2 = kf2.Tcw[:3, :3] @ kf.Ow + kf2.Tcw[:3, 3]
            if abs(c1_in_2[2]) < 1e-6:
                epi = np.array([1e6, 1e6], np.float32)
            else:
                epi = np.array([cam.fx * c1_in_2[0] / c1_in_2[2] + cam.cx,
                                cam.fy * c1_in_2[1] / c1_in_2[2] + cam.cy], np.float32)
            neighbors.append((kf2, F, epi))
        if not neighbors:
            return None
        dev = self.device
        free1 = (kf.points < 0) & kf.valid & ~kf.outliers
        free2 = np.stack([(n[0].points < 0) & n[0].valid & ~n[0].outliers for n in neighbors])
        rows = self._kf_rows([n[0] for n in neighbors])
        ks = self._kf_store
        idx2 = slam_matching.epipolar_triangulation_match(
            kf.dev("kps"), kf.dev("levels"), kf.dev("des"), torch.as_tensor(free1).to(dev),
            ks.kps[rows], ks.levels[rows], ks.des[rows], torch.as_tensor(free2).to(dev),
            torch.as_tensor(np.stack([n[1] for n in neighbors])).to(dev),
            torch.as_tensor(np.stack([n[2] for n in neighbors])).to(dev),
            self._sigma2, float(Parameters.kMaxDescriptorDistance))
        return {"pending": Pending(idx2, dev, long=True), "neighbors": neighbors}

    def _tri_harvest(self, kf: KeyFrame, job: dict) -> int:
        idx2_all = job["pending"].value.cpu().numpy()
        total_new = 0
        for b, (kf2, _, _) in enumerate(job["neighbors"]):
            total_new += self._triangulate_pairs(kf, kf2, idx2_all[b])
        if total_new:
            self.map.update_connections(kf)
        return total_new

    def _triangulate_pairs(self, kf: KeyFrame, kf2: KeyFrame, idx2) -> int:
        """Host half for one neighbour: pairs still free, f64 DLT, gates,
        map insertion."""
        cam = self.camera
        i1 = np.nonzero(idx2 >= 0)[0]
        if len(i1) == 0:
            return 0
        i2 = idx2[i1]
        still_free = (kf.points[i1] < 0) & (kf2.points[i2] < 0)
        i1, i2 = i1[still_free], i2[still_free]
        if len(i1) == 0:
            return 0
        xy1 = np.asarray(cam.unproject_points(kf.kps[i1]))
        xy2 = np.asarray(cam.unproject_points(kf2.kps[i2]))
        pts = geometry.triangulate_dlt_np(kf.Tcw, kf2.Tcw, xy1, xy2)
        sig1 = self.tracker.sigma2[kf.levels[i1]] / cam.fx ** 2
        sig2 = self.tracker.sigma2[kf2.levels[i2]] / cam.fx ** 2
        ok = geometry.triangulation_checks_np(pts, kf.Tcw, kf2.Tcw, xy1, xy2, sig1, sig2,
                                              cos_max_parallax=Parameters.kCosMaxParallax)
        d1 = np.linalg.norm(pts - kf.Ow, axis=1)
        d2 = np.linalg.norm(pts - kf2.Ow, axis=1)
        sf = self.tracker.scale_factors
        ratio_dist = d2 / np.maximum(d1, 1e-9)
        ratio_octave = sf[kf.levels[i1]] / sf[kf2.levels[i2]]
        rf = Parameters.kScaleConsistencyFactor
        ok &= (ratio_dist < ratio_octave * rf) & (ratio_dist * rf > ratio_octave)
        sel = np.nonzero(ok)[0]
        if len(sel) == 0:
            return 0
        pids = self.map.add_points_for_keyframe(kf, i1[sel], pts[sel], kf2=kf2,
                                                kp_idxs2=i2[sel])
        self.map.update_point_descriptors_and_normals(pids)
        self.recent_pids.extend(int(p) for p in pids)
        return len(pids)

    # --------------------------------------------------------- fuse
    def _fuse_dispatch(self, kf: KeyFrame):
        """Project the neighbours' points into kf and kf's points into the
        neighbours (both from the same pre-fuse assignment), on the device;
        the merges are applied at harvest."""
        neighbor_kids = kf.ordered_covisibles(10)
        if not neighbor_kids:
            return None
        st = self.map.points
        store = self.map.device_store()
        dev = self.device
        max_d = float(Parameters.kMaxDescriptorDistance) * 0.5

        def dispatch(cand, masks, targets):
            rows = self._kf_rows(targets)
            ks = self._kf_store
            Tcw = torch.as_tensor(np.stack([t.Tcw for t in targets]).astype(np.float32))
            best, _ = slam_matching.fuse_candidates_kfstore(
                *store, torch.as_tensor(cand).to(dev), torch.as_tensor(np.stack(masks)).to(dev),
                ks.kps, ks.levels, ks.des, ks.valid, ks.kps_ur, rows, Tcw.to(dev),
                self._K, self._bf, self._ib, self._sf, self._sigma2, max_d)
            return best

        parts = []   # (device result, targets, candidate pids)
        neigh_pids = np.asarray(self.map.get_local_map_points(neighbor_kids), np.int64)
        own = kf.points[kf.points >= 0]
        cand = neigh_pids[~np.isin(neigh_pids, own)]
        if len(cand):
            cand = cap_select(cand, Parameters.kTrackLocalMapMaxPoints, score=st.num_obs[cand])
            parts.append((dispatch(cand, [np.ones(len(cand), bool)], [kf]), [kf], cand))
        kf_pids = kf.points[kf.points >= 0]
        kf_pids = np.unique(kf_pids[st.valid[kf_pids]])
        if len(kf_pids):
            targets, masks = [], []
            for kid2 in neighbor_kids:
                kf2 = self.map.keyframes.get(kid2)
                if kf2 is None:
                    continue
                keep = ~np.isin(kf_pids, kf2.points[kf2.points >= 0])
                if keep.any():
                    targets.append(kf2)
                    masks.append(keep)
            if targets:
                parts.append((dispatch(kf_pids, masks, targets), targets, kf_pids))
        if not parts:
            return None
        return {"parts": parts, "pending": Pending(None, dev)}

    def _fuse_harvest(self, kf: KeyFrame, job: dict):
        st = self.map.points
        for best_dev, targets, cand_pids in job["parts"]:
            best = best_dev.cpu().numpy()
            for j, kf2 in enumerate(targets):
                for row, kp_idx in enumerate(best[j]):
                    if kp_idx < 0:
                        continue
                    pid = int(cand_pids[row])
                    if not st.valid[pid]:
                        continue
                    existing = int(kf2.points[kp_idx])
                    if existing >= 0 and st.valid[existing]:
                        if existing == pid:
                            continue
                        if st.num_obs[existing] >= st.num_obs[pid]:
                            self.map.replace_point(pid, existing)
                        else:
                            self.map.replace_point(existing, pid)
                    else:
                        self.map.add_observation(pid, kf2, int(kp_idx))
        self.map.update_point_descriptors_and_normals(np.unique(kf.points[kf.points >= 0]))
        self.map.update_connections(kf)

    # ------------------------------------------------------------ local BA
    def _collect_ba_observations(self, local_pids, kid_to_row, all_kids):
        """Edge list (cam_idx, pt_idx, uv, ur, sigma2) of the window, in the
        order of the map's native mirror (``Map.collect_observations``)."""
        m = self.map
        pt_rows, kids_arr, kp_arr = m.collect_observations(local_pids)
        if len(pt_rows) == 0:
            return None
        max_kid = max(kid_to_row)
        lut = np.full(max_kid + 1, -1, np.int64)
        for kid, row in kid_to_row.items():
            lut[kid] = row
        ok = kids_arr <= max_kid
        cam = np.where(ok, lut[np.clip(kids_arr, 0, max_kid)], -1)
        ok &= cam >= 0
        pt_rows, kp_arr, cam = pt_rows[ok], kp_arr[ok], cam[ok]
        kfs = [m.keyframes[k] for k in all_kids]
        kps_stack = np.stack([k_f.kps for k_f in kfs])
        ur_stack = np.stack([k_f.kps_ur for k_f in kfs])
        lvl_stack = np.stack([k_f.levels for k_f in kfs])
        sig2 = self.tracker.sigma2[lvl_stack[cam, kp_arr]]
        # semantic weighting: information *= w, i.e. sigma2 /= w, gated on
        # ANY labelled keyframe of the window (the newest is labelled only
        # after its LBA); unlabelled keyframes weigh 1
        if (Parameters.kUseSemanticsInOptimization and self.semantic_mapping is not None
                and any(getattr(k_f, "kps_sem", None) is not None for k_f in kfs)):
            sem_stack = np.stack([k_f.kps_sem if getattr(k_f, "kps_sem", None) is not None
                                  else np.full(len(k_f.kps), -1, np.int64) for k_f in kfs])
            w = self.semantic_mapping.get_semantic_weight(sem_stack[cam, kp_arr])
            sig2 = sig2 / np.maximum(np.asarray(w, np.float64), 1e-6)
        return (cam, pt_rows, kps_stack[cam, kp_arr].astype(np.float32),
                ur_stack[cam, kp_arr].astype(np.float32), sig2.astype(np.float32))

    def _lba_build(self, kf: KeyFrame, window_size: int | None = None):
        """The BAProblem of kf's covisibility window (``window_size``
        neighbours, kLocalBAWindowSize by default; with the reference's caps
        on cameras, points and observations), or None."""
        window_kids = [kf.kid] + kf.ordered_covisibles(
            Parameters.kLocalBAWindowSize if window_size is None else window_size)
        window_kids = [k for k in window_kids if k in self.map.keyframes]
        local_pids = self.map.get_local_map_points(window_kids)
        if len(local_pids) < 10:
            return None
        if len(local_pids) > Parameters.kLBAMaxPoints:
            nobs = np.asarray([len(self.map.observations.get(int(p), {})) for p in local_pids])
            local_pids = np.asarray(local_pids)[
                np.argsort(-nobs, kind="stable")[: Parameters.kLBAMaxPoints]]
        window = set(window_kids)
        fixed_counts: dict[int, int] = {}
        for pid in local_pids:
            for kid in self.map.observations.get(int(pid), {}):
                if kid not in window and kid in self.map.keyframes:
                    fixed_counts[kid] = fixed_counts.get(kid, 0) + 1
        max_fixed = Parameters.kLBAMaxCameras - len(window_kids)
        fixed_kids = set(sorted(fixed_counts, key=lambda k: (-fixed_counts[k], k))[:max_fixed])
        all_kids = window_kids + sorted(fixed_kids)
        kid_to_row = {kid: i for i, kid in enumerate(all_kids)}
        obs = self._collect_ba_observations(local_pids, kid_to_row, all_kids)
        if obs is None or len(obs[0]) < 20:
            return None
        n = Parameters.kLBAMaxObservations
        cam_idx, pt_idx, uvs, urs, sig2 = (a[:n] for a in obs)
        fixed = np.zeros(len(all_kids), bool)
        for kid in fixed_kids:
            fixed[kid_to_row[kid]] = True
        first_kid = self.map.keyframe_order[0]
        if first_kid in kid_to_row:
            fixed[kid_to_row[first_kid]] = True
        if not fixed.any():
            fixed[0] = True
        dev = self.device
        problem = optim.BAProblem(
            poses=torch.as_tensor(np.stack([self.map.keyframes[k].Tcw for k in all_kids])
                                  .astype(np.float32)).to(dev),
            points=torch.as_tensor(self.map.points.pos[local_pids].astype(np.float32)).to(dev),
            cam_idx=torch.as_tensor(cam_idx).to(dev),
            pt_idx=torch.as_tensor(pt_idx).to(dev),
            uv=torch.as_tensor(uvs).to(dev),
            ur=torch.as_tensor(urs).to(dev),
            sigma2=torch.as_tensor(sig2).to(dev),
            valid=torch.ones(len(cam_idx), dtype=torch.bool, device=dev),
            fixed=torch.as_tensor(fixed).to(dev),
            K=self._K,
            bf=self._bf,
        )
        meta = {"local_pids": local_pids, "all_kids": all_kids, "kid_to_row": kid_to_row,
                "fixed": fixed, "cam_idx": cam_idx, "pt_idx": pt_idx}
        return problem, meta

    def _lba_dispatch(self, kf: KeyFrame, window_size: int | None = None):
        """Dispatch the first LM chunk of the window's BA (never waits)."""
        # an interrupt stops further chunks, never the window's first one
        self.opt_abort_flag = False
        built = self._lba_build(kf, window_size)
        if built is None:
            return
        problem, meta = built
        total = Parameters.kOptimizerLBAIterations
        chunk = max(2, (total + 1) // 2)
        rest = total - min(chunk, total)
        result = optim.bundle_adjust(problem, iters=min(chunk, total), return_state=True)
        meta.update(problem=problem, chunk=chunk, iters_left=-(-rest // chunk) * chunk,
                    pending=Pending(result, self.device))
        self._lba = meta

    def _lba_poll(self, block: bool) -> bool:
        """When the current chunk is done, dispatch the next one or (last
        chunk, or abort requested) apply the result."""
        lba = self._lba
        if block:
            lba["pending"].wait()
        elif not lba["pending"].ready():
            return False
        poses, points, _, lam, inl = lba["pending"].value
        if lba["iters_left"] > 0 and not self.opt_abort_flag:
            prob = lba["problem"]._replace(poses=poses, points=points)
            lba["problem"] = prob
            lba["pending"] = Pending(
                optim.bundle_adjust(prob, iters=lba["chunk"], lam0=lam, return_state=True),
                self.device)
            lba["iters_left"] -= lba["chunk"]
            return True
        self._lba_apply(lba, poses, points, inl)
        self._lba = None
        self.opt_abort_flag = False
        return True

    def _lba_apply(self, lba: dict, poses_dev, points_dev, inl_dev):
        """Write the LBA result back, guarding against map changes made
        while its chunks were in flight."""
        local_pids = lba["local_pids"]
        all_kids = lba["all_kids"]
        st = self.map.points
        new_poses = poses_dev.cpu().numpy().astype(np.float64)
        new_points = points_dev.cpu().numpy().astype(np.float64)
        if not (np.isfinite(new_poses).all() and np.isfinite(new_points).all()):
            Printer.red("LBA diverged (non-finite result): discarding update")
            return
        inlier_mask = inl_dev.cpu().numpy()
        cam_idx, pt_idx = lba["cam_idx"], lba["pt_idx"]
        for o in np.nonzero(~inlier_mask)[0]:
            self.map.remove_observation(int(local_pids[pt_idx[o]]), all_kids[cam_idx[o]])
        for kid, row in lba["kid_to_row"].items():
            if not lba["fixed"][row] and kid in self.map.keyframes:
                self.map.keyframes[kid].update_pose(new_poses[row])
                self.map.keyframes[kid].lba_count += 1
        alive = st.valid[local_pids]
        st.pos[local_pids[alive]] = new_points[alive]
        self.map._mark_dirty(local_pids[alive], pos_only=True)
        self.lba_applied += 1

    # --------------------------------------------------------- cull keyframes
    def cull_keyframes(self, kf: KeyFrame):
        """90%-redundancy rule."""
        for kid in kf.ordered_covisibles():
            kf_o = self.map.keyframes.get(kid)
            if kf_o is None or kid == self.map.keyframe_order[0]:
                continue
            pids = kf_o.points[kf_o.points >= 0]
            if len(pids) == 0:
                continue
            n_redundant = 0
            n_points = 0
            for kp_idx, pid in zip(np.nonzero(kf_o.points >= 0)[0], pids):
                pid = int(pid)
                if not self.map.points.valid[pid]:
                    continue
                obs = self.map.observations.get(pid, {})
                n_points += 1
                if len(obs) <= Parameters.kKeyframeCullingMinNumPoints:
                    continue
                level = kf_o.levels[kp_idx]
                n_better = 0
                for okid, okp in obs.items():
                    if okid == kid:
                        continue
                    okf = self.map.keyframes.get(okid)
                    if okf is None:
                        continue
                    if okf.levels[okp] <= level + 1:
                        n_better += 1
                        if n_better >= Parameters.kKeyframeCullingMinNumPoints:
                            break
                if n_better >= Parameters.kKeyframeCullingMinNumPoints:
                    n_redundant += 1
            if n_points > 0 and n_redundant > (
                    Parameters.kKeyframeCullingRedundantObsRatio * n_points):
                self.map.remove_keyframe(kf_o)
                if self._kf_store is not None:
                    self._kf_store.invalidate(kid)
