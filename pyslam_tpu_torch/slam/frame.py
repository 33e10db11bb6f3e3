"""Frame and KeyFrame: per-image containers (port of the fused stereo branch
of ``pyslam_tpu/slam/frame.py:77-103`` and of ``KeyFrame``).

A frame's extraction stays on the device: ``dev(name)`` returns the device
tensors (``kps``, ``levels``, ``des``, ``valid``, ``kps_ur``) that the
tracking and mapping kernels consume.  The small per-keypoint fields are
also copied to the host once (one transfer), because the state machine,
the keyframe policy and the map bookkeeping are host code; the descriptor
block is copied only when a host consumer reads ``des`` (keyframes do).
The map-point assignment ``points`` and ``outliers`` are host arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.slam.camera import PinholeCamera


class Frame:
    _id_counter = 0

    def __init__(self, camera: PinholeCamera, img=None, img_right=None,
                 timestamp: float = 0.0, feature_tracker=None,
                 frame_id: int | None = None):
        if frame_id is None:
            self.id = Frame._id_counter
            Frame._id_counter += 1
        else:
            self.id = frame_id
        self.camera = camera
        self.timestamp = timestamp
        self.Tcw = np.eye(4)  # world -> camera
        self.is_keyframe = False
        self.feature_tracker = feature_tracker
        self.device = (feature_tracker.device if feature_tracker is not None
                       else torch.device("cpu"))
        self._dev: dict[str, torch.Tensor] = {}
        self._des_np = None
        if img is None or feature_tracker is None:
            return
        extractor = feature_tracker.extractor
        if img_right is not None:
            max_disp = (camera.bf / max(Parameters.kMinDepth, 1e-3)
                        if camera.bf > 0 else 100.0)
            fd, ur, depth = extractor.extract_stereo(
                img, img_right, bf=camera.bf, max_disp=max_disp,
                max_distance=Parameters.kStereoMatchingMaxDescriptorDistance,
                row_tol=Parameters.kStereoMatchingRowTolerance)
        else:
            fd = extractor(img)
            ur = depth = torch.full_like(fd.xy[:, 0], -1.0)
        self._dev = {"kps": fd.xy, "levels": fd.level, "des": fd.desc,
                     "valid": fd.valid, "kps_ur": ur}
        # one device->host transfer for all small per-keypoint fields
        meta = torch.stack([fd.xy[:, 0], fd.xy[:, 1], fd.level.to(torch.float32),
                            fd.angle, fd.size, fd.valid.to(torch.float32), ur, depth],
                           1).cpu().numpy()
        self.set_host_fields(
            kps=np.ascontiguousarray(meta[:, 0:2]), levels=meta[:, 2].astype(np.int32),
            angles=meta[:, 3].copy(), sizes=meta[:, 4].copy(), valid=meta[:, 5] > 0.5,
            kps_ur=meta[:, 6].copy(), depths=meta[:, 7].copy())

    def set_host_fields(self, kps, levels, angles, sizes, valid, kps_ur, depths):
        """Host copies of the per-keypoint fields; resets the assignment."""
        self.kps = kps
        self.levels = levels
        self.angles = angles
        self.sizes = sizes
        self.valid = valid
        self.kps_ur = kps_ur
        self.depths = depths
        n = len(kps)
        self.num_kps = n
        self.points = np.full((n,), -1, np.int64)
        self.outliers = np.zeros((n,), bool)

    # ---------------------------------------------------------- device data
    def dev(self, name: str) -> torch.Tensor:
        """Device tensor of an immutable per-frame field (uploaded from the
        host copy the first time when the frame was built from host data)."""
        t = self._dev.get(name)
        if t is None:
            host = self.des if name == "des" else getattr(self, name)
            t = torch.as_tensor(np.array(host)).to(self.device)
            if name == "levels":
                t = t.to(torch.int64)
            self._dev[name] = t
        return t

    def drop_device_cache(self):
        """Free the device tensors (a culled keyframe)."""
        self._dev = {}

    @property
    def des(self) -> np.ndarray:
        """Host descriptor block, copied from the device on first access."""
        if self._des_np is None:
            self._des_np = self._dev["des"].cpu().numpy()
        return self._des_np

    @des.setter
    def des(self, value):
        self._des_np = np.asarray(value)
        self._dev.pop("des", None)

    # ---------------------------------------------------------------- pose
    @property
    def Twc(self) -> np.ndarray:
        return np.linalg.inv(self.Tcw)

    @property
    def Ow(self) -> np.ndarray:
        """Camera centre in world coordinates."""
        return -self.Tcw[:3, :3].T @ self.Tcw[:3, 3]

    def update_pose(self, Tcw):
        self.Tcw = np.asarray(Tcw, np.float64).reshape(4, 4)

    # ------------------------------------------------------------- helpers
    def unproject_keypoints(self, idxs=None):
        """Back-project keypoints with valid depth to world coordinates."""
        if idxs is None:
            idxs = np.nonzero(self.depths > 0)[0]
        uv = self.kps[idxs]
        z = self.depths[idxs]
        pc = np.asarray(self.camera.backproject_points(uv, z))
        Twc = self.Twc
        return (Twc[:3, :3] @ pc.T).T + Twc[:3, 3], idxs

    def sigma2_for(self, idxs) -> np.ndarray:
        return self.feature_tracker.sigma2[self.levels[idxs]]


class KeyFrame(Frame):
    """Frame + covisibility graph node.  ``kid`` is assigned by
    ``Map.add_keyframe`` (per-map counter)."""

    def __init__(self, frame: Frame, kid: int | None = None):
        _ = frame.des   # keyframes feed host consumers: materialise it first
        self.__dict__.update(frame.__dict__)   # share arrays (no copy)
        self._dev = dict(frame._dev)
        self.kid = kid
        self.is_keyframe = True
        self.is_bad = False
        self.connected_keyframes: dict[int, int] = {}  # kid -> weight
        self.ordered_neighbors: list[int] = []
        self.parent: int | None = None
        self.children: set[int] = set()
        self.loop_edges: set[int] = set()
        self.not_to_erase = False
        self.lba_count = 0

    def ordered_covisibles(self, n: int | None = None) -> list[int]:
        if n is None:
            return list(self.ordered_neighbors)
        return self.ordered_neighbors[:n]

    def add_connection(self, kid: int, weight: int):
        self.connected_keyframes[kid] = weight
        self._reorder()

    def erase_connection(self, kid: int):
        if kid in self.connected_keyframes:
            del self.connected_keyframes[kid]
            self._reorder()

    def _reorder(self):
        self.ordered_neighbors = [
            k for k, _ in sorted(self.connected_keyframes.items(), key=lambda kv: -kv[1])
        ]
