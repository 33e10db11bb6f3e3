"""Frame and KeyFrame: per-image containers (port of
``pyslam_tpu/slam/frame.py:77-160``, ``:306-321`` and of ``KeyFrame``).

A frame is built from a stereo pair (the fused extraction and row match of
a rectified camera whose extractor has one, ``extract_stereo``; otherwise
both images extracted apart and row-matched with the matcher's distance,
as the reference's ``compute_stereo_matches``), from an image and its depth
map (RGBD: virtual right coordinates from the sensor depth,
``compute_stereo_from_rgbd``) or from one image (monocular).  Descriptors
keep the extractor's layout: int8 bits (256 to 512 of them) or float32.
Keypoints are undistorted once at construction; the raw (distorted) ones
are kept as ``kps_raw``.

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
from pyslam_tpu_torch.features.orb2 import stereo_match
from pyslam_tpu_torch.slam.camera import PinholeCamera


def compute_stereo_from_rgbd(kps: torch.Tensor, kps_raw: torch.Tensor, valid: torch.Tensor,
                             depth: torch.Tensor, bf: float, min_depth: float):
    """RGBD -> per-keypoint depth and virtual right coordinate (reference
    ``frame.py:306-321``): the depth map (H, W) is read at the rounded raw
    keypoint (clamped to the image), a depth <= ``min_depth`` or an invalid
    keypoint gives -1, and ``ur = u - bf / z`` on the undistorted u where
    ``bf`` > 0 (else -1).  The depth is metric (the dataset readers divide
    by the camera's depth factor; the reference's own division never fires,
    its depth being float32 by then).  Discrete and exactly rounded: the
    same bits on the CPU and the card (round half to even as numpy, a true
    float32 division by a tensor, not a reciprocal).  Returns (ur, depth)
    (N,) float32 on the keypoints' device."""
    h, w = depth.shape[-2:]
    xs = torch.clamp(torch.round(kps_raw[:, 0]).to(torch.int64), 0, w - 1)
    ys = torch.clamp(torch.round(kps_raw[:, 1]).to(torch.int64), 0, h - 1)
    z = depth.reshape(-1)[ys * w + xs].to(torch.float32)
    ok = (z > min_depth) & valid
    minus1 = torch.full_like(z, -1.0)
    ur = minus1
    if bf > 0:
        bf_t = torch.tensor(bf, dtype=torch.float32, device=z.device)
        ur = torch.where(ok, kps[:, 0] - bf_t / torch.clamp(z, min=1e-6), minus1)
    return ur, torch.where(ok, z, minus1)


class Frame:
    _id_counter = 0

    def __init__(self, camera: PinholeCamera, img=None, img_right=None, depth=None,
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
            # no extraction: empty slots in the reference's default layout
            n = Parameters.kNumFeatures
            z = np.zeros((n,), np.float32)
            self._des_np = np.zeros((n, 256), np.int8)
            minus1 = np.full((n,), -1.0, np.float32)
            self.set_host_fields(kps=np.zeros((n, 2), np.float32),
                                 levels=np.zeros((n,), np.int32), angles=z, sizes=z.copy(),
                                 valid=np.zeros((n,), bool), kps_ur=minus1,
                                 depths=minus1.copy())
            return
        extractor = feature_tracker.extractor
        max_disp = camera.bf / max(Parameters.kMinDepth, 1e-3) if camera.bf > 0 else 100.0
        stereo_args = dict(bf=camera.bf, max_disp=max_disp,
                           max_distance=Parameters.kStereoMatchingMaxDescriptorDistance,
                           row_tol=Parameters.kStereoMatchingRowTolerance)
        if (img_right is not None and not camera.is_distorted
                and hasattr(extractor, "extract_stereo")):
            # fused: both images in one batch, then the row match
            fd, ur, z = extractor.extract_stereo(img, img_right, **stereo_args)
            kps = fd.xy
        else:
            fd = feature_tracker.detectAndCompute(img)
            kps = camera.undistort_points(fd.xy)
            if img_right is not None:
                fr = feature_tracker.detectAndCompute(img_right)
                ur, z = stereo_match(fd._replace(xy=kps), fr, **stereo_args,
                                     distance=feature_tracker.matcher.distance_matrix)
            elif depth is not None:
                ur, z = compute_stereo_from_rgbd(
                    kps, fd.xy, fd.valid, torch.as_tensor(np.asarray(depth)).to(self.device),
                    camera.bf, Parameters.kMinDepth)
            else:
                ur = z = torch.full_like(fd.xy[:, 0], -1.0)
        self._dev = {"kps": kps, "levels": fd.level, "des": fd.desc,
                     "valid": fd.valid, "kps_ur": ur}
        # one device->host transfer for all small per-keypoint fields
        meta = torch.stack([kps[:, 0], kps[:, 1], fd.xy[:, 0], fd.xy[:, 1],
                            fd.level.to(torch.float32), fd.angle, fd.size,
                            fd.valid.to(torch.float32), ur, z], 1).cpu().numpy()
        self.set_host_fields(
            kps=np.ascontiguousarray(meta[:, 0:2]), levels=meta[:, 4].astype(np.int32),
            angles=meta[:, 5].copy(), sizes=meta[:, 6].copy(), valid=meta[:, 7] > 0.5,
            kps_ur=meta[:, 8].copy(), depths=meta[:, 9].copy(),
            kps_raw=np.ascontiguousarray(meta[:, 2:4]))

    def set_host_fields(self, kps, levels, angles, sizes, valid, kps_ur, depths,
                        kps_raw=None):
        """Host copies of the per-keypoint fields (``kps`` undistorted,
        ``kps_raw`` as detected: the same for an undistorted camera); resets
        the assignment."""
        self.kps = kps
        self.kps_raw = kps if kps_raw is None else kps_raw
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
