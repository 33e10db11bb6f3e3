"""Synthetic stereo/RGBD stream: a deterministic blob-textured 3D world
rendered along a parametric camera trajectory with exact ground truth.

Copied from ``SyntheticWorld`` and ``SyntheticDataset`` of
``pyslam_tpu/io/dataset.py``: the port renders byte-identical frames from the
same seed, so both packages can be driven with the same input.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pyslam_tpu_torch.io.dataset_types import SensorType


class DatasetBase:
    """Iteration surface shared by the datasets (``getImage(i)`` ...)."""

    sensor_type = SensorType.MONOCULAR
    num_frames = 0
    fps = 30.0

    def getImage(self, i: int) -> np.ndarray | None:
        raise NotImplementedError

    def getImageRight(self, i: int) -> np.ndarray | None:
        return None

    def getDepth(self, i: int) -> np.ndarray | None:
        return None

    def getTimestamp(self, i: int) -> float:
        return i / self.fps

    def __len__(self) -> int:
        return self.num_frames


@dataclass
class SyntheticWorld:
    """Deterministic 3D blob world + camera trajectory for hermetic tests."""

    n_points: int = 3000
    extent: float = 30.0
    depth_range: tuple = (4.0, 40.0)
    seed: int = 7
    textured: bool = False   # per-blob sinusoid texture (see __post_init__)
    points: np.ndarray = field(init=False)
    intensities: np.ndarray = field(init=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # Surface-dominated world: a box room (4 walls + floor + ceiling at
        # +-extent) textured with blobs, plus a sparse interior set for
        # close-range stereo parallax.  A purely volumetric cloud has severe
        # occlusion churn — every small viewpoint change flips z-buffer
        # winners, which destroys feature matchability across >2-3 frames
        # (measured 450 points -> 18 matches at 7 frames apart).
        e = self.extent
        h = e * 0.15
        n_wall = int(self.n_points * 0.8)
        n_int = self.n_points - n_wall
        u = rng.uniform(-e, e, (n_wall, 1))
        v = rng.uniform(-h, h, (n_wall, 1))
        face = rng.integers(0, 6, n_wall)
        pts = np.zeros((n_wall, 3))
        # walls: x=+-e, z=+-e + floor/ceiling y=+-h (z offset so trajectories
        # centered near z in [0, 2e*0.4] stay inside)
        zc = e * 0.4
        for i in range(n_wall):
            if face[i] == 0:
                pts[i] = [e, v[i, 0], u[i, 0] + zc]
            elif face[i] == 1:
                pts[i] = [-e, v[i, 0], u[i, 0] + zc]
            elif face[i] == 2:
                pts[i] = [u[i, 0], v[i, 0], e + zc]
            elif face[i] == 3:
                pts[i] = [u[i, 0], v[i, 0], -e + zc]
            elif face[i] == 4:
                pts[i] = [u[i, 0], h, rng.uniform(-e, e) + zc]
            else:
                pts[i] = [u[i, 0], -h, rng.uniform(-e, e) + zc]
        interior = np.stack(
            [
                rng.uniform(-e * 0.8, e * 0.8, n_int),
                rng.uniform(-h, h, n_int),
                rng.uniform(-e * 0.8, e * 0.8, n_int) + zc,
            ],
            axis=1,
        )
        self.points = np.concatenate([pts, interior], axis=0)
        self.intensities = rng.uniform(80, 255, self.n_points).astype(np.float32)
        self.radii = rng.uniform(1.5, 4.0, self.n_points).astype(np.float32)
        # per-blob intensity gradient: uniform-intensity blobs make every
        # corner look identical and break ratio-test matching
        self.gradients = rng.uniform(-6.0, 6.0, (self.n_points, 2)).astype(np.float32)
        if self.textured:
            # per-blob pseudo-random sinusoid texture: descriptor-DISTINCTIVE
            # interiors (a linear gradient alone leaves BRIEF patterns of
            # different blobs near-identical, which aliases loop-closure
            # guided matching into ~100% false correspondences on revisits)
            self.tex_freq = rng.uniform(0.3, 0.9, (self.n_points, 2)).astype(
                np.float32)
            self.tex_phase = rng.uniform(0, 2 * np.pi, (self.n_points, 2)).astype(
                np.float32)
            self.tex_amp = rng.uniform(15.0, 35.0, self.n_points).astype(
                np.float32)


class SyntheticDataset(DatasetBase):
    """Renders the blob world along a smooth trajectory with exact GT.

    Rendering: project world points, splat square blobs of per-point constant
    intensity (nearest wins by depth).  Produces FAST-trackable corners at
    blob corners, stereo pair via a horizontal baseline, and dense depth maps
    — enough to drive the full mono/stereo/RGBD SLAM stack hermetically.
    """

    def __init__(
        self,
        num_frames: int = 60,
        h: int = 240,
        w: int = 320,
        fx: float = 200.0,
        baseline: float = 0.2,
        trajectory: str = "arc",
        sensor_type=SensorType.STEREO,
        world: SyntheticWorld | None = None,
        step: float = 0.25,
        period: int | None = None,
        textured: bool = False,
    ):
        self.sensor_type = sensor_type
        self.num_frames = num_frames
        self.h, self.w = h, w
        self.fx = self.fy = fx
        self.cx, self.cy = w / 2.0, h / 2.0
        self.baseline = baseline
        self.fps = 10.0
        self.world = world or SyntheticWorld(textured=textured)
        self.step = step
        self.trajectory = trajectory
        # for "loop": revolution period in frames (default num_frames); with
        # period < num_frames the tail frames exactly revisit the start poses
        self.period = period or num_frames
        self.poses = self._make_trajectory()  # (T,4,4) Twc (camera->world)

    def _make_trajectory(self):
        poses = []
        for i in range(self.num_frames):
            if self.trajectory == "line":
                t = np.array([0.0, 0.0, i * self.step])
                yaw = 0.0
            elif self.trajectory == "arc":
                th = 0.004 * i * i * 0.1 + 0.01 * i
                radius = 60.0
                t = np.array(
                    [radius * (1 - np.cos(th * 0.3)), 0.0, radius * np.sin(th * 0.3)]
                )
                yaw = th * 0.3
            elif self.trajectory == "loop":
                th = 2 * np.pi * i / self.period
                radius = 12.0
                t = np.array([radius * np.sin(th), 0.0, radius * (1 - np.cos(th))])
                yaw = th
            else:
                raise ValueError(self.trajectory)
            c, s = np.cos(yaw), np.sin(yaw)
            Rwc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            T = np.eye(4)
            T[:3, :3] = Rwc
            T[:3, 3] = t
            poses.append(T)
        return np.stack(poses)

    @property
    def K(self):
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float64
        )

    def groundtruth_Twc(self, i):
        return self.poses[i]

    def _render(self, Tcw):
        w_pts = self.world.points
        pc = (Tcw[:3, :3] @ w_pts.T).T + Tcw[:3, 3]
        z = pc[:, 2]
        vis = z > 2.0  # near clip: a too-close blob would cover the frame
        u = self.fx * pc[:, 0] / np.where(vis, z, 1.0) + self.cx
        v = self.fy * pc[:, 1] / np.where(vis, z, 1.0) + self.cy
        img = np.full((self.h, self.w), 30.0, np.float32)
        zbuf = np.full((self.h, self.w), np.inf, np.float32)
        order = np.argsort(-z)  # far to near: near overwrites
        for idx in order:
            if not vis[idx]:
                continue
            r = int(np.clip(round(self.world.radii[idx] * self.fx / (z[idx] * 5.0)), 1, 14))
            x0, y0 = int(round(u[idx])), int(round(v[idx]))
            if x0 + r < 0 or x0 - r >= self.w or y0 + r < 0 or y0 - r >= self.h:
                continue
            xa, xb = max(x0 - r, 0), min(x0 + r + 1, self.w)
            ya, yb = max(y0 - r, 0), min(y0 + r + 1, self.h)
            patch_z = zbuf[ya:yb, xa:xb]
            mask = patch_z > z[idx]
            gx, gy = self.world.gradients[idx]
            yy, xx = np.mgrid[ya - y0 : yb - y0, xa - x0 : xb - x0]
            vals = self.world.intensities[idx] + gx * xx + gy * yy
            if self.world.textured:
                fxt, fyt = self.world.tex_freq[idx]
                pxt, pyt = self.world.tex_phase[idx]
                vals = vals + self.world.tex_amp[idx] * (
                    np.sin(fxt * xx + pxt) * np.sin(fyt * yy + pyt)
                )
            vals = np.clip(vals, 40.0, 255.0).astype(np.float32)
            img[ya:yb, xa:xb][mask] = vals[mask]
            patch_z[mask] = z[idx]
        return img, zbuf

    def _Tcw(self, i, right=False):
        Twc = self.poses[i].copy()
        if right:
            Twc[:3, 3] += Twc[:3, :3] @ np.array([self.baseline, 0, 0])
        Tcw = np.eye(4)
        Tcw[:3, :3] = Twc[:3, :3].T
        Tcw[:3, 3] = -Twc[:3, :3].T @ Twc[:3, 3]
        return Tcw

    def getImage(self, i):
        img, _ = self._render(self._Tcw(i))
        return img

    def getImageRight(self, i):
        if self.sensor_type != SensorType.STEREO:
            return None
        img, _ = self._render(self._Tcw(i, right=True))
        return img

    def getDepth(self, i):
        if self.sensor_type != SensorType.RGBD:
            return None
        _, zbuf = self._render(self._Tcw(i))
        depth = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
        return depth

    def getTimestamp(self, i):
        return i / self.fps
