"""TSDF integration over the voxel-hash table (port of
``pyslam_tpu/dense/tsdf.py``).

Per keyframe, every strided depth pixel emits a band of voxel updates along
its ray inside the truncation region, and the updates are fused into the
table with one ``ops.voxel_hash.insert_and_accumulate`` call.  The spatial
queries, carving, mesh extraction and persistence work on host copies of the
table, as in the reference.

Rounding follows the reference's compiled CPU code, so that the voxel
coordinates are identical: the camera-to-world product of each coordinate
is ``fma(z, r2, fma(y, r1, x * r0)) + t`` (one rounding for each fused
multiply-add, emulated in float64), every division by a scalar is a true
division (CUDA turns a division by a host scalar into a multiply by its
reciprocal, so the divisor is a device tensor), and the intensity is scaled
by the float32 reciprocal of 255, as XLA rewrites a division by a constant.
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.interop import voxel_table_from_numpy
from pyslam_tpu_torch.ops import voxel_hash
from pyslam_tpu_torch.ops.voxel_hash import fma32
from pyslam_tpu_torch.utils.device import as_device_tensor

_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """True float32 division by a scalar on any device."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def depth_to_voxel_updates(depth: torch.Tensor, intensity: torch.Tensor, Twc: torch.Tensor,
                           K: torch.Tensor, voxel_size: float, sdf_trunc: float,
                           depth_trunc: float, stride: int = 2, band_steps: int = 5,
                           phase: int = 0, phases: int = 1):
    """(coords (N,3) int32, sdf, w, color, valid) voxel updates of one depth
    image (H,W) (<= 0 invalid), seen from camera-to-world ``Twc``.

    ``phases > 1`` emits only every ``phases``-th strided row (offset
    ``phase``); all phases have one shape (rows are padded to the ceiling
    and masked)."""
    H, W = depth.shape
    dev = depth.device
    n_strided = -(-H // stride)
    n_rows = -(-n_strided // phases)
    ys_raw = (phase + phases * torch.arange(n_rows, device=dev)) * stride
    row_ok = ys_raw < H
    ys = torch.clamp(ys_raw, max=H - 1)
    xs = torch.arange(0, W, stride, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    ok_row = row_ok[:, None].expand(gy.shape).reshape(-1)
    gy = gy.reshape(-1)
    gx = gx.reshape(-1)
    d = depth[gy, gx]
    inten = intensity[gy, gx]
    valid_px = (d > 0.05) & (d < depth_trunc) & ok_row

    # unit-z ray directions in the camera frame
    rx = (gx.to(torch.float32) - K[0, 2]) / K[0, 0]
    ry = (gy.to(torch.float32) - K[1, 2]) / K[1, 1]
    offsets = (torch.arange(2 * band_steps + 1, dtype=torch.float32, device=dev)
               - band_steps) * voxel_size
    dz = d[:, None] + offsets[None, :]                     # (P,B) sample depth along z
    sdf = _div(d[:, None] - dz, sdf_trunc)                 # normalised tsdf
    px, py = rx[:, None] * dz, ry[:, None] * dz
    pw = torch.stack([fma32(dz, Twc[i, 2], fma32(py, Twc[i, 1], px * Twc[i, 0])) + Twc[i, 3]
                      for i in range(3)], dim=-1)          # (P,B,3) world coords
    coords = torch.floor(_div(pw, voxel_size)).to(torch.int32)

    # weights: full inside the truncation, linear falloff behind the surface
    w = torch.clamp(1.0 - torch.clamp(-sdf, min=0.0) * 0.5, 0.2, 1.0)
    valid = valid_px[:, None] & (sdf.abs() <= 1.0) & (dz > 0.05)
    col = inten[:, None].expand(sdf.shape) * _INV_255
    return coords.reshape(-1, 3), sdf.reshape(-1), w.reshape(-1), col.reshape(-1), \
        valid.reshape(-1)


class TSDFVolume:
    """Host facade over the device table: integrate, extract a point cloud
    or mesh, spatial queries and carving, reset, save and load."""

    def __init__(self, voxel_size: float | None = None, sdf_trunc: float | None = None,
                 depth_trunc: float | None = None, capacity: int | None = None,
                 stride: int | None = None, *, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.voxel_size = voxel_size or Parameters.kVolumetricIntegrationVoxelSize
        self.sdf_trunc = sdf_trunc or Parameters.kVolumetricIntegrationSdfTrunc
        self.depth_trunc = depth_trunc or Parameters.kVolumetricIntegrationDepthTruncIndoor
        self.capacity = capacity or Parameters.kVolumetricIntegrationTableCapacity
        # stride None: picked at the first integrate so that the ray spacing
        # at the far clip (depth_trunc / fx * stride) stays <= voxel_size
        self.stride = stride
        # samples on each side of the surface: one a voxel across the
        # truncation region, capped (sdf is still normalised by sdf_trunc)
        self.band_steps = int(np.clip(round(self.sdf_trunc / self.voxel_size), 2,
                                      Parameters.kVolumetricIntegrationBandMaxSteps))
        self.table = voxel_hash.make_table(self.capacity, device=self.device)
        self.num_integrated = 0

    def integrate(self, depth, intensity, Twc, K, phase: int = 0, phases: int = 1):
        """Fuse one depth image, or with ``phases > 1`` one row-interleaved
        subset of it."""
        if self.stride is None:
            fx = float(np.asarray(K)[0, 0])
            self.stride = int(np.clip(self.voxel_size * fx / max(self.depth_trunc, 1e-6), 1, 4))
        dev = self.device
        coords, sdf, w, col, valid = depth_to_voxel_updates(
            as_device_tensor(depth, dev), as_device_tensor(intensity, dev),
            as_device_tensor(Twc, dev), as_device_tensor(K, dev),
            self.voxel_size, self.sdf_trunc, self.depth_trunc, self.stride, self.band_steps,
            phase, phases)
        self.table = voxel_hash.insert_and_accumulate(self.table, coords, sdf, w, col, valid)
        if phase == phases - 1:
            self.num_integrated += 1

    def reset(self):
        self.table = voxel_hash.make_table(self.capacity, device=self.device)
        self.num_integrated = 0

    # ------------------------------------------------------------ host copies
    def _np(self, name: str) -> np.ndarray:
        return getattr(self.table, name).cpu().numpy()

    def num_voxels(self) -> int:
        return int(self.table.occupied.sum())

    def extract_point_cloud(self, tsdf_band: float = 0.5, min_weight: float = 1.0):
        """Voxel centres near the zero crossing -> (points (N,3), colors)."""
        tsdf = self._np("tsdf")
        sel = self._np("occupied") & (np.abs(tsdf) < tsdf_band) & (self._np("weight") >= min_weight)
        pts = (self._np("keys")[sel].astype(np.float64) + 0.5) * self.voxel_size
        return pts, self._np("color")[sel]

    def extract_mesh(self, min_weight: float = 1.0):
        """Zero-isosurface triangle mesh by marching tetrahedra: (vertices
        (M,3), faces (F,3), vertex colors (M,3) or None)."""
        from pyslam_tpu_torch.dense.marching import marching_tetrahedra

        sel = self._np("occupied") & (self._np("weight") >= min_weight)
        return marching_tetrahedra(self._np("keys")[sel], self._np("tsdf")[sel],
                                   colors=self._np("color")[sel], voxel_size=self.voxel_size)

    def save_mesh(self, path: str, min_weight: float = 1.0):
        from pyslam_tpu_torch.dense.marching import save_ply

        verts, faces, cols = self.extract_mesh(min_weight)
        save_ply(path, verts, faces, cols)
        return len(verts), len(faces)

    # ------------------------------------------- spatial queries / carving
    def _centers(self) -> np.ndarray:
        return (self._np("keys").astype(np.float64) + 0.5) * self.voxel_size

    def voxels_in_bbox(self, min_xyz, max_xyz) -> np.ndarray:
        """Occupied-voxel mask inside an axis-aligned 3D bounding box."""
        c = self._centers()
        return (self._np("occupied") & (c >= np.asarray(min_xyz)).all(1)
                & (c <= np.asarray(max_xyz)).all(1))

    def _clear_slots(self, idx):
        """Free table slots: clear ``occupied`` and zero tsdf, weight and
        color, so that a voxel that later claims the slot starts fresh."""
        i = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        t = self.table
        self.table = t._replace(occupied=t.occupied.index_fill(0, i, False),
                                tsdf=t.tsdf.index_fill(0, i, 0.0),
                                weight=t.weight.index_fill(0, i, 0.0),
                                color=t.color.index_fill(0, i, 0.0))

    def crop_bbox(self, min_xyz, max_xyz):
        """Drop every voxel outside the box."""
        drop = self._np("occupied") & ~self.voxels_in_bbox(min_xyz, max_xyz)
        self._clear_slots(np.flatnonzero(drop))

    def voxels_in_frustum(self, Twc, K, hw, near: float = 0.05,
                          far: float | None = None) -> np.ndarray:
        """Occupied-voxel mask inside the camera frustum."""
        H, W = hw
        far = far or self.depth_trunc
        Tcw = np.linalg.inv(np.asarray(Twc, np.float64))
        pc = self._centers() @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        K = np.asarray(K)
        with np.errstate(divide="ignore", invalid="ignore"):
            u = K[0, 0] * pc[:, 0] / z + K[0, 2]
            v = K[1, 1] * pc[:, 1] / z + K[1, 2]
        return (self._np("occupied") & (z > near) & (z < far)
                & (u >= 0) & (u < W) & (v >= 0) & (v < H))

    def carve(self, depth, Twc, K, margin: float | None = None) -> int:
        """Space carving: clear the voxels the camera sees through (inside
        the frustum and closer than the measured surface by > margin).
        Returns the number of carved voxels."""
        depth = np.asarray(depth, np.float32)
        H, W = depth.shape
        margin = margin or 2.0 * self.voxel_size
        in_f = self.voxels_in_frustum(Twc, K, (H, W))
        if not in_f.any():
            return 0
        Tcw = np.linalg.inv(np.asarray(Twc, np.float64))
        pc = self._centers()[in_f] @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        K = np.asarray(K)
        u = np.clip((K[0, 0] * pc[:, 0] / z + K[0, 2]).astype(int), 0, W - 1)
        v = np.clip((K[1, 1] * pc[:, 1] / z + K[1, 2]).astype(int), 0, H - 1)
        d = depth[v, u]
        idx = np.flatnonzero(in_f)[(d > 0) & (z < d - margin)]
        if len(idx) == 0:
            return 0
        self._clear_slots(idx)
        return int(len(idx))

    # ---------------------------------------------------------- persistence
    def save(self, path: str):
        """``.npz`` in the layout of the JAX package's ``TSDFVolume.save``."""
        np.savez_compressed(path, keys=self._np("keys"), occupied=self._np("occupied"),
                            tsdf=self._np("tsdf"), weight=self._np("weight"),
                            color=self._np("color"), voxel_size=self.voxel_size,
                            sdf_trunc=self.sdf_trunc)

    def load(self, path: str):
        """Read a volume written by ``save`` here or in the JAX package."""
        z = np.load(path)
        self.voxel_size = float(z["voxel_size"])
        self.sdf_trunc = float(z["sdf_trunc"])
        self.table = voxel_table_from_numpy(z["keys"], z["occupied"], z["tsdf"], z["weight"],
                                            z["color"], device=self.device)
