"""Global bundle adjustment over the whole map (port of
``pyslam_tpu/slam/global_bundle_adjustment.py:31-276``).

GBA is one Schur-complement LM solve over every keyframe and map point
(``ops.optim.bundle_adjust``); the map's SoA layout makes the problem pure
indexing.  :class:`AsyncGBA` runs it as the reference's concurrent
GBA-then-correct protocol: the solve is dispatched as chunks of LM
iterations whose completion is polled through a CUDA event (ready at once
on the CPU) while tracking goes on; on completion the result is written back
and the correction is carried to everything born during the solve,
keyframes through the spanning tree and points through their first
keyframe's old -> new pose.  A new loop correction aborts or supersedes a
solve in flight, and the stale result is discarded.
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.ops import optim
from pyslam_tpu_torch.slam.local_mapping import Pending
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.utils.logging import Printer
from pyslam_tpu_torch.utils.profiling import StageTimings


def build_full_problem(m: Map, camera, feature_tracker, *,
                       device: torch.device | str = "cuda"):
    """The whole map as a BAProblem on ``device`` (the first keyframe fixed
    as the gauge), with its keyframe ids and point ids in row order."""
    kids = list(m.keyframe_order)
    kid_to_row = {k: i for i, k in enumerate(kids)}
    pids = m.points.alive_ids()
    pt_l, kid_l, kp_l = [], [], []
    for i, pid in enumerate(pids):
        for kid, kp_idx in m.observations.get(int(pid), {}).items():
            pt_l.append(i)
            kid_l.append(kid)
            kp_l.append(kp_idx)
    pt_rows = np.asarray(pt_l, np.int64)
    kids_arr = np.asarray(kid_l, np.int64)
    kp_arr = np.asarray(kp_l, np.int64)
    max_kid = max(kids) if kids else 0
    lut = np.full(max_kid + 1, -1, np.int64)
    for kid, row in kid_to_row.items():
        lut[kid] = row
    ok = kids_arr <= max_kid
    cam_idx = np.where(ok, lut[np.clip(kids_arr, 0, max_kid)], -1)
    ok &= cam_idx >= 0
    pt_idx, kp_arr, cam_idx = pt_rows[ok], kp_arr[ok], cam_idx[ok]
    kps_stack = np.stack([m.keyframes[k].kps for k in kids])
    ur_stack = np.stack([m.keyframes[k].kps_ur for k in kids])
    lvl_stack = np.stack([m.keyframes[k].levels for k in kids])
    fixed = np.zeros(len(kids), bool)
    fixed[0] = True

    def put(x, dtype=None):
        x = np.asarray(x) if dtype is None else np.asarray(x, dtype)
        return torch.as_tensor(x).to(device)

    problem = optim.BAProblem(
        poses=put(np.stack([m.keyframes[k].Tcw for k in kids]), np.float32),
        points=put(m.points.pos[pids], np.float32),
        cam_idx=put(cam_idx), pt_idx=put(pt_idx),
        uv=put(kps_stack[cam_idx, kp_arr], np.float32),
        ur=put(ur_stack[cam_idx, kp_arr], np.float32),
        sigma2=put(feature_tracker.sigma2[lvl_stack[cam_idx, kp_arr]], np.float32),
        valid=torch.ones(len(cam_idx), dtype=torch.bool, device=device),
        fixed=put(fixed), K=put(camera.K, np.float32),
        bf=torch.tensor(camera.bf, dtype=torch.float32, device=device))
    return problem, kids, pids


def global_bundle_adjustment(m: Map, camera, feature_tracker, iters: int | None = None, *,
                             device: torch.device | str = "cuda") -> float:
    """Run GBA and write the result into the map; returns the final cost
    (inf, and the map untouched, when the solve diverged)."""
    iters = iters or Parameters.kOptimizerGBAIterations
    if m.num_keyframes() < 2:
        return 0.0
    problem, kids, pids = build_full_problem(m, camera, feature_tracker, device=device)
    new_poses, new_points, cost = optim.bundle_adjust(problem, iters=iters)
    new_poses = new_poses.cpu().numpy().astype(np.float64)
    new_points = new_points.cpu().numpy().astype(np.float64)
    if not (np.isfinite(new_poses).all() and np.isfinite(new_points).all()):
        Printer.red("GBA diverged (non-finite result): discarding update")
        return float("inf")
    for i, kid in enumerate(kids):
        if i > 0:
            m.keyframes[kid].update_pose(new_poses[i])
    m.points.pos[pids] = new_points
    m.store_version += 1
    return float(cost)


class AsyncGBA:
    """Chunked, abortable whole-map BA with the correction carried to what
    was born during the solve."""

    def __init__(self, camera, feature_tracker, *, device: torch.device | str = "cuda"):
        self.camera = camera
        self.feature_tracker = feature_tracker
        self.device = torch.device(device)
        self._state: dict | None = None
        self.abort_flag = False
        self.runs_completed = 0
        self.runs_aborted = 0
        self.last_cost = float("nan")
        self.timings = StageTimings("gba")

    @property
    def running(self) -> bool:
        return self._state is not None

    def dispatch(self, m: Map, iters: int | None = None):
        """Start a GBA over the map's current keyframes and points; a solve
        already in flight is superseded (counted aborted, discarded)."""
        if self._state is not None:
            self.runs_aborted += 1
            self._state = None
        self.abort_flag = False
        iters = iters or Parameters.kOptimizerGBAIterations
        if m.num_keyframes() < 2:
            return
        with self.timings.stage("gba_dispatch"):
            problem, kids, pids = build_full_problem(m, self.camera, self.feature_tracker,
                                                     device=self.device)
            chunk = max(2, iters // 3)
            result = optim.bundle_adjust(problem, iters=min(chunk, iters), return_state=True)
        self._state = {"map": m, "problem": problem, "kids": kids, "pids": np.asarray(pids),
                       "chunk": chunk, "iters_left": iters - min(chunk, iters),
                       "pending": Pending(result, self.device)}

    def abort(self):
        """A new loop mid-solve: stop after the chunk in flight and discard."""
        if self._state is not None:
            self.abort_flag = True

    def poll(self, block: bool = False) -> bool:
        """Service the solve in flight; True while work remains.  Does not
        wait on the device unless ``block``."""
        st = self._state
        if st is None:
            return False
        if block:
            st["pending"].wait()
        elif not st["pending"].ready():
            return True
        poses, points, cost, lam = st["pending"].value[:4]
        if self.abort_flag:
            self._state = None
            self.abort_flag = False
            self.runs_aborted += 1
            return False
        if st["iters_left"] > 0:
            with self.timings.stage("gba_chunk"):
                prob = st["problem"]._replace(poses=poses, points=points)
                n = min(st["chunk"], st["iters_left"])
                st["problem"] = prob
                st["pending"] = Pending(
                    optim.bundle_adjust(prob, iters=n, lam0=lam, return_state=True),
                    self.device)
                st["iters_left"] -= n
            return True
        with self.timings.stage("gba_apply"):
            self._apply(st, poses, points, cost)
        self._state = None
        return False

    def finish(self):
        while self.poll(block=True):
            pass

    def _apply(self, st: dict, poses_dev, points_dev, cost_dev):
        m: Map = st["map"]
        kids = st["kids"]
        pids = st["pids"]
        new_poses = poses_dev.cpu().numpy().astype(np.float64)
        new_points = points_dev.cpu().numpy().astype(np.float64)
        if not (np.isfinite(new_poses).all() and np.isfinite(new_points).all()):
            Printer.red("async GBA diverged (non-finite): discarding update")
            return
        self.last_cost = float(cost_dev)
        self.runs_completed += 1
        in_snapshot = set(kids)
        pts = m.points
        # poses at apply time: local mapping may have refined a parent and
        # its child coherently during the solve, and the relative pose as it
        # stands now is what the correction keeps
        Tcw_pre = {kid: kf.Tcw.copy() for kid, kf in m.keyframes.items()}

        # 1. snapshot keyframes: direct write-back (the gauge row stays)
        corrected = set()
        for i, kid in enumerate(kids):
            kf = m.keyframes.get(kid)
            if kf is None:
                continue
            corrected.add(kid)
            if i > 0:
                kf.update_pose(new_poses[i])

        # 2. keyframes born during the solve: spanning-tree composition
        # (parents come first in keyframe_order, so chains correct in turn)
        n_born_kfs = 0
        for kid in m.keyframe_order:
            kf = m.keyframes[kid]
            if kid in in_snapshot:
                continue
            parent = kf.parent
            if parent is None or parent not in corrected:
                continue
            T_rel = Tcw_pre[kid] @ np.linalg.inv(Tcw_pre[parent])
            kf.update_pose(T_rel @ m.keyframes[parent].Tcw)
            corrected.add(kid)
            n_born_kfs += 1

        # 3. snapshot points: direct write-back (skip since-deleted slots)
        alive = pts.valid[pids]
        pids_alive = pids[alive]
        pts.pos[pids_alive] = new_points[: len(pids)][alive]

        # 4. points born during the solve move with their first keyframe
        born_later = np.setdiff1d(pts.alive_ids(), pids, assume_unique=False)
        for pid in born_later:
            ref_kid = int(pts.first_kid[pid])
            kf = m.keyframes.get(ref_kid)
            if kf is None or ref_kid not in corrected:
                continue
            T_pre = Tcw_pre[ref_kid]
            p_cam = T_pre[:3, :3] @ pts.pos[pid] + T_pre[:3, 3]
            Twc = kf.Twc
            pts.pos[pid] = Twc[:3, :3] @ p_cam + Twc[:3, 3]
        m.store_version += 1
        Printer.green(f"async GBA applied: {len(kids)} KFs (+{n_born_kfs} born-during), "
                      f"{len(pids_alive)} pts (+{len(born_later)} born-during), "
                      f"cost {self.last_cost:.3f}")
