"""Global map: SoA map-point store + keyframe registry + covisibility
(port of ``pyslam_tpu/slam/map.py``).

Map points are rows of capacity-growing host numpy arrays; observations are
host dicts {pid: {kid: kp_idx}} (the pure-Python observation graph: the
reference's optional native mirror is not ported).  ``device_store()``
keeps a device copy of the arrays the tracking and fuse kernels read, and
syncs it by rows: the mutators record which rows changed, and the sync
writes just those rows into the device tensors IN PLACE (``index_copy_``)
— the full store is uploaded only on first use, on growth, or after an
external ``store_version`` write.
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.slam.frame import KeyFrame


class MapPointStorage:
    """Capacity-doubling SoA store for map points."""

    def __init__(self, capacity: int | None = None):
        cap = capacity or Parameters.kMapPointCapacityInitial
        self._alloc(cap)
        self.size = 0  # high-water mark (ids are never reused)

    def _alloc(self, cap):
        self.capacity = cap
        self.pos = np.zeros((cap, 3), np.float64)
        self.desc = np.zeros((cap, 256), np.int8)
        self.normal = np.zeros((cap, 3), np.float32)
        self.min_dist = np.zeros((cap,), np.float32)
        self.max_dist = np.full((cap,), np.inf, np.float32)
        self.valid = np.zeros((cap,), bool)       # alive (not culled/replaced)
        self.n_visible = np.zeros((cap,), np.int32)
        self.n_found = np.zeros((cap,), np.int32)
        self.first_kid = np.full((cap,), -1, np.int32)
        self.num_obs = np.zeros((cap,), np.int32)
        self.replaced_by = np.full((cap,), -1, np.int64)

    def _grow(self):
        old = self.__dict__.copy()
        # 4x growth: each step re-uploads the device store, so take few
        cap = self.capacity * 4
        self._alloc(cap)
        self.ensure_desc_layout(old["desc"])  # keep the adopted (dim, dtype)
        for name in ("pos", "desc", "normal", "min_dist", "max_dist", "valid",
                     "n_visible", "n_found", "first_kid", "num_obs",
                     "replaced_by"):
            getattr(self, name)[: old["capacity"]] = old[name]
        self.size = old["size"]

    def ensure_desc_layout(self, des: np.ndarray):
        """Adopt the session's descriptor layout (dim, dtype) on first use:
        ORB2 stores 256 unpacked bits as int8, BRISK/FREAK/BEBLID 512 and
        AKAZE 486, SIFT/SURF/KAZE float32 of their own dimension.  The store
        starts in the ORB2 layout and re-allocates the descriptor block
        once when the first written descriptors differ (before any point
        exists)."""
        dim, dtype = des.shape[1], des.dtype
        if self.desc.shape[1] != dim or self.desc.dtype != dtype:
            self.desc = np.zeros((self.capacity, dim), dtype)

    def alive_ids(self) -> np.ndarray:
        return np.nonzero(self.valid[: self.size])[0]

    def new_points(self, n: int) -> np.ndarray:
        while self.size + n > self.capacity:
            self._grow()
        ids = np.arange(self.size, self.size + n)
        self.size += n
        return ids


class Map:
    def __init__(self, *, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.points = MapPointStorage()
        self.keyframes: dict[int, KeyFrame] = {}       # kid -> KeyFrame
        self.keyframe_order: list[int] = []            # insertion order
        # bumped on every point-store mutation: device-resident caches of
        # the store (Tracking.track_fused) key on it.  Internal mutators
        # call _mark_dirty (delta-tracked); external writers assigning
        # ``store_version`` directly trip the overflow flag and force a full
        # re-upload (see device_store)
        self._store_version = 0
        self._dirty_pos: set[int] = set()    # rows whose pos changed
        self._dirty_full: set[int] = set()   # rows with any field changed
        self._dirty_overflow = True          # True => full upload needed
        # observations: pid -> {kid: kp_idx}
        self.observations: dict[int, dict[int, int]] = {}
        # callbacks fired on delete_point(pid)/replace_point(old,new) so
        # sidecar per-point stores (semantic accumulators, embeddings) can
        # prune/merge; signature cb(old_pid, new_pid_or_None)
        self.point_removal_listeners: list = []
        self.max_frame_id = 0
        self.max_keyframe_id = 0
        # per-map kid counter: keyframe ids must be sequential WITHIN a map
        # (kid deltas drive freshness/culling logic), so assignment lives
        # here, not on a process-global class attribute
        self.next_kid = 0
        self._dev_store = None   # see device_store()
        self._dev_version = -1   # store_version the device copy reflects

    # store_version stays the public cache key (consumers compare it), but
    # plain ``map.store_version += 1`` from outside (GBA, loop correction —
    # whole-map pose/point rewrites) must invalidate the delta state: the
    # setter trips the overflow flag, while internal mutators use
    # _mark_dirty to record exactly which rows changed.
    @property
    def store_version(self) -> int:
        return self._store_version

    @store_version.setter
    def store_version(self, v: int):
        self._store_version = v
        self._dirty_overflow = True

    def _mark_dirty(self, pids, pos_only: bool = False):
        """Record changed store rows + bump the version WITHOUT tripping the
        full-upload flag (device_store applies these as scatter deltas)."""
        self._store_version += 1
        tgt = self._dirty_pos if pos_only else self._dirty_full
        if np.isscalar(pids):
            tgt.add(int(pids))
        else:
            tgt.update(int(p) for p in np.atleast_1d(pids))

    def device_store(self):
        """Device copy of the point-store arrays (pos f32, desc, normal,
        min_dist, max_dist with +inf replaced by 1, valid), shared by the
        tracking step and the fuse stage.  Mutates the cached device
        tensors in place when only some rows changed."""
        st = self.points
        key = (st.capacity, st.desc.shape[1], str(st.desc.dtype))
        n_full = len(self._dirty_full)
        n_pos = len(self._dirty_pos | self._dirty_full)
        if (self._dev_store is None or self._dev_store[0] != key or self._dirty_overflow
                or n_pos > st.capacity // 4):
            dev = self.device
            self._dev_store = (key, (
                torch.as_tensor(st.pos.astype(np.float32)).to(dev),
                torch.as_tensor(st.desc).to(dev),
                torch.as_tensor(st.normal).to(dev),
                torch.as_tensor(st.min_dist).to(dev),
                torch.as_tensor(self._max_dist_rows(slice(None))).to(dev),
                torch.as_tensor(st.valid).to(dev),
            ))
            self._dirty_overflow = False
            self._dirty_pos.clear()
            self._dirty_full.clear()
            self._dev_version = self._store_version
            return self._dev_store[1]
        if self._dev_version != self._store_version:
            pos_d, desc_d, norm_d, mind_d, maxd_d, valid_d = self._dev_store[1]
            if n_full:
                rows = np.fromiter(self._dirty_full, np.int64, n_full)
                idx = torch.as_tensor(rows).to(self.device)
                for dst, src in ((desc_d, st.desc[rows]), (norm_d, st.normal[rows]),
                                 (mind_d, st.min_dist[rows]),
                                 (maxd_d, self._max_dist_rows(rows)),
                                 (valid_d, st.valid[rows])):
                    dst.index_copy_(0, idx, torch.as_tensor(src).to(self.device))
            if n_pos:
                rows = np.asarray(sorted(self._dirty_pos | self._dirty_full), np.int64)
                pos_d.index_copy_(0, torch.as_tensor(rows).to(self.device),
                                  torch.as_tensor(st.pos[rows].astype(np.float32)).to(self.device))
            self._dirty_pos.clear()
            self._dirty_full.clear()
            self._dev_version = self._store_version
        return self._dev_store[1]

    def _max_dist_rows(self, rows) -> np.ndarray:
        md = self.points.max_dist[rows]
        return np.where(np.isfinite(md), md, 1.0).astype(np.float32)

    # ------------------------------------------------------------ keyframes
    def add_keyframe(self, kf: KeyFrame):
        if kf.kid is None:
            kf.kid = self.next_kid
        self.next_kid = max(self.next_kid, kf.kid + 1)
        self.keyframes[kf.kid] = kf
        self.keyframe_order.append(kf.kid)
        self.max_keyframe_id = max(self.max_keyframe_id, kf.kid)

    def remove_keyframe(self, kf: KeyFrame):
        """Cull a keyframe: drop its observations, fix spanning tree."""
        if kf.kid not in self.keyframes:
            return
        for kp_idx, pid in enumerate(kf.points):
            if pid >= 0:
                self.remove_observation(int(pid), kf.kid)
        kf.points[:] = -1
        # detach from covisibility
        for other_kid in list(kf.connected_keyframes.keys()):
            other = self.keyframes.get(other_kid)
            if other is not None:
                other.erase_connection(kf.kid)
        # re-parent children to kf's parent
        for child_kid in list(kf.children):
            child = self.keyframes.get(child_kid)
            if child is not None:
                child.parent = kf.parent
                if kf.parent is not None and kf.parent in self.keyframes:
                    self.keyframes[kf.parent].children.add(child_kid)
        if kf.parent is not None and kf.parent in self.keyframes:
            self.keyframes[kf.parent].children.discard(kf.kid)
        kf.is_bad = True
        kf.drop_device_cache()   # free its device tensors
        del self.keyframes[kf.kid]
        self.keyframe_order.remove(kf.kid)

    def num_keyframes(self) -> int:
        return len(self.keyframes)

    def last_keyframe(self) -> KeyFrame | None:
        return self.keyframes[self.keyframe_order[-1]] if self.keyframe_order else None

    # --------------------------------------------------------- observations
    def add_observation(self, pid: int, kf: KeyFrame, kp_idx: int):
        obs = self.observations.setdefault(pid, {})
        if kf.kid in obs:
            return
        obs[kf.kid] = int(kp_idx)
        kf.points[kp_idx] = pid
        self.points.num_obs[pid] = len(obs)

    def remove_observation(self, pid: int, kid: int):
        obs = self.observations.get(pid)
        if obs is None or kid not in obs:
            return
        kp_idx = obs.pop(kid)
        kf = self.keyframes.get(kid)
        if kf is not None and 0 <= kp_idx < len(kf.points) and kf.points[kp_idx] == pid:
            kf.points[kp_idx] = -1
        self.points.num_obs[pid] = len(obs)
        if len(obs) == 0:
            self.delete_point(pid)

    def delete_point(self, pid: int):
        self._mark_dirty(pid)
        obs = self.observations.pop(pid, {})
        for kid, kp_idx in obs.items():
            kf = self.keyframes.get(kid)
            if kf is not None and kf.points[kp_idx] == pid:
                kf.points[kp_idx] = -1
        self.points.valid[pid] = False
        for cb in self.point_removal_listeners:
            cb(int(pid), None)

    def replace_point(self, old_pid: int, new_pid: int):
        """MapPoint.replace_with semantics (reference map_point.py): rebind all
        observations of old to new, merge stats."""
        if old_pid == new_pid:
            return
        self._mark_dirty([old_pid, new_pid])
        obs_old = self.observations.pop(old_pid, {})
        st = self.points
        for kid, kp_idx in obs_old.items():
            kf = self.keyframes.get(kid)
            if kf is None:
                continue
            obs_new = self.observations.setdefault(new_pid, {})
            if kid in obs_new:
                # keyframe already sees the new point: drop the duplicate slot
                if kf.points[kp_idx] == old_pid:
                    kf.points[kp_idx] = -1
            else:
                obs_new[kid] = kp_idx
                kf.points[kp_idx] = new_pid
        st.n_visible[new_pid] += st.n_visible[old_pid]
        st.n_found[new_pid] += st.n_found[old_pid]
        st.num_obs[new_pid] = len(self.observations.get(new_pid, {}))
        st.replaced_by[old_pid] = new_pid
        st.valid[old_pid] = False
        for cb in self.point_removal_listeners:
            cb(int(old_pid), int(new_pid))

    def resolve_replacements(self, pids: np.ndarray) -> np.ndarray:
        """Follow replaced_by chains (bounded) for an id array."""
        out = np.asarray(pids).copy()
        for _ in range(4):
            rb = self.points.replaced_by[np.clip(out, 0, self.points.size - 1)]
            mask = (out >= 0) & (rb >= 0)
            if not mask.any():
                break
            out[mask] = rb[mask]
        return out

    # --------------------------------------------------------------- points
    def add_points_for_keyframe(
        self,
        kf: KeyFrame,
        kp_idxs: np.ndarray,
        positions: np.ndarray,
        kf2: KeyFrame | None = None,
        kp_idxs2: np.ndarray | None = None,
    ) -> np.ndarray:
        """Create new map points observed by kf (and optionally kf2)."""
        n = len(kp_idxs)
        if n == 0:
            return np.zeros(0, np.int64)
        pids = self.points.new_points(n)
        self._mark_dirty(pids)
        st = self.points
        st.pos[pids] = positions
        st.valid[pids] = True
        st.first_kid[pids] = kf.kid
        st.ensure_desc_layout(kf.des)
        st.desc[pids] = kf.des[kp_idxs]
        self._init_point_geometry(pids, kf, kp_idxs)
        for j, (pid, ki) in enumerate(zip(pids, kp_idxs)):
            self.add_observation(int(pid), kf, int(ki))
            if kf2 is not None and kp_idxs2 is not None:
                self.add_observation(int(pid), kf2, int(kp_idxs2[j]))
        st.n_visible[pids] = 1
        st.n_found[pids] = 1
        return pids

    def _init_point_geometry(self, pids, kf: KeyFrame, kp_idxs):
        st = self.points
        d = st.pos[pids] - kf.Ow[None, :]
        dist = np.linalg.norm(d, axis=1)
        st.normal[pids] = (d / np.maximum(dist[:, None], 1e-9)).astype(np.float32)
        levels = kf.levels[kp_idxs]
        sf = kf.feature_tracker.scale_factors
        level_scale = sf[levels]
        n_levels = len(sf)
        st.max_dist[pids] = (dist * level_scale).astype(np.float32)
        st.min_dist[pids] = (
            st.max_dist[pids] / sf[n_levels - 1]
        ).astype(np.float32)

    # per-point observation cap for the best-descriptor update: the median-
    # distance argmin stabilizes after a handful of views, and the batched
    # host pass below is O(P * CAP^2 * D)
    _DESC_UPDATE_OBS_CAP = 8

    def update_point_descriptors_and_normals(self, pids):
        """Recompute best descriptor (min-median-distance, reference
        map_point.py best-descriptor update) and mean viewing direction.

        Vectorized over the whole pid batch: observation rows are flattened
        once, descriptors/levels/centers gathered per KEYFRAME (one fancy
        index per touched keyframe instead of one per observation), and the
        median-distance argmin runs as one padded (P, CAP, CAP) computation
        — the per-point Python loop cost ~100 ms/keyframe at 2k points,
        which dominated the local-mapping host slice."""
        self._mark_dirty(pids)
        st = self.points
        CAP = self._DESC_UPDATE_OBS_CAP
        # ---- flatten observation rows (latest CAP per point; dicts keep
        # insertion order so the tail = most recent observations) + the
        # reference (oldest-kid) observation for the scale range
        rows_pid: list[int] = []
        rows_kid: list[int] = []
        rows_idx: list[int] = []
        ref_rows: list[tuple[int, int, int]] = []   # (pid, kid, kp_idx)
        for pid in np.atleast_1d(pids):
            pid = int(pid)
            obs = self.observations.get(pid)
            if not obs or not st.valid[pid]:
                continue
            items = [(k, i) for k, i in obs.items() if k in self.keyframes]
            if not items:
                continue
            for kid, ki in items[-CAP:]:
                rows_pid.append(pid)
                rows_kid.append(kid)
                rows_idx.append(ki)
            ref_kid = min(obs.keys())
            if ref_kid in self.keyframes:
                ref_rows.append((pid, ref_kid, obs[ref_kid]))
        if not rows_pid:
            return
        rows_pid = np.asarray(rows_pid, np.int64)
        rows_kid = np.asarray(rows_kid, np.int64)
        rows_idx = np.asarray(rows_idx, np.int64)
        # grouping below requires pid-contiguous rows in ascending order;
        # callers may pass unsorted pids
        order = np.argsort(rows_pid, kind="stable")
        rows_pid, rows_kid, rows_idx = (
            rows_pid[order], rows_kid[order], rows_idx[order]
        )
        n_rows = len(rows_pid)

        # ---- gather per-keyframe payloads: one fancy index per keyframe
        any_kf = self.keyframes[int(rows_kid[0])]
        desc_dim = any_kf.des.shape[1]
        desc_dtype = any_kf.des.dtype
        descs = np.empty((n_rows, desc_dim), desc_dtype)
        ows = np.empty((n_rows, 3), np.float64)
        levels = np.empty((n_rows,), np.int64)
        sfs = None
        for kid in np.unique(rows_kid):
            kf = self.keyframes[int(kid)]
            sel = rows_kid == kid
            descs[sel] = kf.des[rows_idx[sel]]
            levels[sel] = kf.levels[rows_idx[sel]]
            ows[sel] = kf.Ow
            sfs = kf.feature_tracker.scale_factors

        # ---- group rows by pid into a (P, CAP) padded layout
        upids, starts = np.unique(rows_pid, return_index=True)
        # rows are emitted pid-contiguously above, so each pid's rows are
        # the slice [start, start+count)
        counts = np.diff(np.append(starts, n_rows))
        P = len(upids)
        col = np.arange(n_rows) - np.repeat(starts, counts)
        grid = np.zeros((P, CAP), np.int64)        # row index per (p, j)
        gvalid = np.zeros((P, CAP), bool)
        prow = np.repeat(np.arange(P), counts)
        grid[prow, col] = np.arange(n_rows)
        gvalid[prow, col] = True

        # ---- mean viewing direction (normalized mean of unit vectors)
        v = st.pos[rows_pid] - ows
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
        vsum = np.zeros((P, 3))
        np.add.at(vsum, prow, v)
        nrm = np.linalg.norm(vsum, axis=1, keepdims=True)
        normals = np.where(nrm > 1e-9, vsum / np.maximum(nrm, 1e-9),
                           vsum / counts[:, None])
        st.normal[upids] = normals.astype(np.float32)

        # ---- best descriptor: min median distance to co-observations
        D = descs[grid]                             # (P, CAP, desc_dim)
        if np.issubdtype(desc_dtype, np.floating):
            dot = np.einsum("pid,pjd->pij", D, D, optimize=True)
            sq = np.einsum("pid,pid->pi", D, D, optimize=True)
            dm = np.sqrt(np.maximum(sq[:, :, None] + sq[:, None, :]
                                    - 2.0 * dot, 0.0))
        else:
            # unpacked 0/1 bit descriptors: hamming = |a|+|b|-2 a.b
            Df = D.astype(np.float32)
            dot = np.einsum("pid,pjd->pij", Df, Df, optimize=True)
            pop = Df.sum(-1)
            dm = pop[:, :, None] + pop[:, None, :] - 2.0 * dot
        BIG = 1e12
        pair_ok = gvalid[:, :, None] & gvalid[:, None, :]
        dm = np.where(pair_ok, dm, np.nan)
        # self-distance 0 on every diagonal: padded rows then have one
        # non-nan entry (no all-NaN-slice warnings); they are masked below
        ii = np.arange(CAP)
        dm[:, ii, ii] = 0.0
        med = np.nanmedian(dm, axis=2)              # (P, CAP)
        med = np.where(gvalid, med, BIG)
        best = np.argmin(med, axis=1)
        st.desc[upids] = descs[grid[np.arange(P), best]]

        # ---- scale-invariance range from the reference observation
        if ref_rows and sfs is not None:
            r_pid = np.asarray([r[0] for r in ref_rows], np.int64)
            r_kid = np.asarray([r[1] for r in ref_rows], np.int64)
            r_idx = np.asarray([r[2] for r in ref_rows], np.int64)
            r_ow = np.empty((len(r_pid), 3), np.float64)
            r_lvl = np.empty((len(r_pid),), np.int64)
            for kid in np.unique(r_kid):
                kf = self.keyframes[int(kid)]
                sel = r_kid == kid
                r_ow[sel] = kf.Ow
                r_lvl[sel] = kf.levels[r_idx[sel]]
            dist = np.linalg.norm(st.pos[r_pid] - r_ow, axis=1)
            st.max_dist[r_pid] = (dist * sfs[r_lvl]).astype(np.float32)
            st.min_dist[r_pid] = (st.max_dist[r_pid] / sfs[-1]).astype(
                np.float32)

    # --------------------------------------------------------- covisibility
    def update_connections(self, kf: KeyFrame, min_weight: int | None = None):
        """Rebuild kf's covisibility edges from shared map points (reference
        ``keyframe.py update_connections``; weight >= 15 shared points)."""
        if min_weight is None:
            min_weight = Parameters.kMinNumOfCovisiblePointsForCreatingConnection
        pids = kf.points[kf.points >= 0]
        counter = {}
        for pid in pids:
            obs = self.observations.get(int(pid))
            if not obs:
                continue
            for kid in obs.keys():
                if kid != kf.kid:
                    counter[kid] = counter.get(kid, 0) + 1
        if not counter:
            return
        best_kid = max(counter, key=counter.get)
        kept = {k: w for k, w in counter.items() if w >= min_weight}
        if not kept:
            kept = {best_kid: counter[best_kid]}
        kf.connected_keyframes = kept
        kf._reorder()
        for kid, w in kept.items():
            other = self.keyframes.get(kid)
            if other is not None:
                other.add_connection(kf.kid, w)
        # spanning tree: first connection becomes parent
        if kf.parent is None and kf.kid != self.keyframe_order[0]:
            kf.parent = best_kid
            self.keyframes[best_kid].children.add(kf.kid)

    def get_local_keyframes(self, kf: KeyFrame, max_n: int | None = None) -> list[int]:
        max_n = max_n or Parameters.kMaxNumOfKeyframesInLocalMap
        out = [kf.kid] + kf.ordered_covisibles(max_n)
        return out[:max_n]

    def get_local_map_points(self, kids: list[int]) -> np.ndarray:
        pids: set[int] = set()
        for kid in kids:
            kf = self.keyframes.get(kid)
            if kf is None:
                continue
            pids.update(int(p) for p in kf.points[kf.points >= 0])
        alive = [p for p in pids if self.points.valid[p]]
        return np.asarray(sorted(alive), np.int64)

    # ------------------------------------------------------------ statistics
    def num_points(self) -> int:
        return int(self.points.valid[: self.points.size].sum())
