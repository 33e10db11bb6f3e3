"""Scene from views: the multi-view reconstruction pipeline (port of
``pyslam_tpu/scene_from_views/scene_from_views.py``; reference surface
pySLAM ``pyslam/scene_from_views/scene_from_views_base.py``:
``reconstruct() = preprocess_images() -> infer() -> postprocess_results()``,
and ``scene_from_views_factory``).

Backends, each on ``device``:
- GEOMETRIC: ORB2 features (1500 on 4 levels, one ``fast_nms`` launch a
  view), Hamming matching of consecutive views, the essential matrix by
  RANSAC (512 hypotheses at a Sampson threshold of (1.5 / fx)^2) with
  cheirality pose recovery, the pose chain, and float64 DLT triangulation
  of each pair's inliers gated to depths of 0.2-100 m.  The minimal
  samples come from a ``sampler`` (default: a ``torch.Generator`` seeded
  3, where the reference splits ``PRNGKey(3)`` once a pair; the parity
  tests inject the reference's draws).
- DUST3R and MAST3R: consecutive pairs, each pair's frame registered into
  the world through the shared view's pointmaps (Umeyama with scale); the
  pointmaps come to the host once a pair.
- VGGT (and VGGT_ROBUST, which drops views by the anchor-attention mass),
  FAST3R (poses by Umeyama between each view's local and global
  pointmaps), MVDUST3R and DEPTH_ANYTHING_V3: one forward pass over all
  views, the confident points concatenated.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from pyslam_tpu_torch.evaluation.metrics import umeyama_np
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
from pyslam_tpu_torch.ops import epipolar, geometry
from pyslam_tpu_torch.utils.logging import Printer
from pyslam_tpu_torch.utils.padding import pad_bucket, pad_rows


class SceneFromViewsType(enum.Enum):
    GEOMETRIC = "geometric"
    DUST3R = "dust3r"
    MAST3R = "mast3r"
    MVDUST3R = "mvdust3r"
    VGGT = "vggt"
    VGGT_ROBUST = "vggt_robust"
    FAST3R = "fast3r"
    DEPTH_ANYTHING_V3 = "depth_anything_v3"


@dataclass
class SceneFromViewsResult:
    poses: np.ndarray                 # (V, 4, 4) camera -> world
    points: np.ndarray                # (N, 3)
    colors: np.ndarray | None = None
    per_view_matches: list = field(default_factory=list)


def _concat(clouds: list) -> np.ndarray:
    return np.concatenate(clouds, 0) if clouds else np.zeros((0, 3))


def _umeyama_T(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """4x4 similarity mapping the finite rows of ``a`` onto ``b``."""
    a, b = a.reshape(-1, 3), b.reshape(-1, 3)
    ok = np.isfinite(a).all(1) & np.isfinite(b).all(1)
    s, R, t = umeyama_np(a[ok], b[ok], with_scale=True)
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


class SceneFromViewsBase:
    def __init__(self, camera=None, *, device: torch.device | str = "cuda", **kw):
        self.camera = camera
        self.device = torch.device(device)

    def reconstruct(self, images: list) -> SceneFromViewsResult:
        return self.postprocess_results(self.infer(self.preprocess_images(images)))

    def preprocess_images(self, images):
        return [np.asarray(im, np.float32) for im in images]

    def infer(self, data):
        raise NotImplementedError

    def postprocess_results(self, out):
        return out


class SceneFromViewsGeometric(SceneFromViewsBase):
    """Classical reconstruction on the port's own feature and RANSAC ops."""

    def __init__(self, camera, num_features: int = 1500, *, device="cuda", sampler=None,
                 seed: int = 3, **kw):
        super().__init__(camera, device=device)
        self.tracker = feature_tracker_factory(
            FeatureTrackerConfig(num_features=num_features, num_levels=4), device=self.device)
        self.sampler = sampler or epipolar.generator_sampler(self.device, seed)

    def infer(self, images) -> SceneFromViewsResult:
        cam, dev = self.camera, self.device
        feats = [self.tracker.detectAndCompute(im) for im in images]
        poses = [np.eye(4)]  # Twc chain
        all_pts = []
        matches_log = []
        for i in range(len(images) - 1):
            f1, f2 = feats[i], feats[i + 1]
            i1, i2 = self.tracker.match(f1, f2)
            matches_log.append(len(i1))
            if len(i1) < 30:
                Printer.yellow(f"scene_from_views: weak pair {i}-{i + 1}")
                poses.append(poses[-1].copy())
                continue
            xy1 = cam.unproject_points(f1.xy.cpu().numpy()[i1])
            xy2 = cam.unproject_points(f2.xy.cpu().numpy()[i2])
            xy1p, valid = pad_bucket(xy1.astype(np.float32))
            xy2p = pad_rows(xy2.astype(np.float32), len(valid))
            x1, x2 = torch.from_numpy(xy1p).to(dev), torch.from_numpy(xy2p).to(dev)
            vm = torch.from_numpy(valid).to(dev)
            E, mask, n_inl = epipolar.find_essential(x1, x2, vm, (1.5 / cam.fx) ** 2, 512,
                                                     samples=self.sampler(vm, 512, 8))
            if int(n_inl) < 15:
                poses.append(poses[-1].copy())
                continue
            T21, front = epipolar.recover_pose(E, x1, x2, mask)
            T21 = T21.cpu().numpy()
            # triangulate in the pair's frames, lifted to the world by the chain
            T1w = np.linalg.inv(poses[i])  # world -> cam_i
            T2w = T21 @ T1w
            tri = geometry.triangulate_dlt(torch.from_numpy(T1w).to(dev),
                                           torch.from_numpy(T2w).to(dev),
                                           x1.double(), x2.double()).cpu().numpy()
            ok = (mask & front).cpu().numpy()[: len(xy1)]
            pts = tri[: len(xy1)][ok]
            pc = pts @ T1w[:3, :3].T + T1w[:3, 3]
            keep = (pc[:, 2] > 0.2) & (pc[:, 2] < 100.0)
            all_pts.append(pts[keep])
            poses.append(poses[i] @ np.linalg.inv(T21))
        return SceneFromViewsResult(poses=np.stack(poses), points=_concat(all_pts),
                                    per_view_matches=matches_log)


class SceneFromViewsDust3r(SceneFromViewsBase):
    """DUSt3R-class pairwise pointmaps (``models.dust3r``): consecutive pairs
    chained by registering each pair's frame into the world through the
    shared view's pointmaps (Umeyama with scale; the reference's global
    alignment optimiser is not part of it)."""

    def __init__(self, camera=None, checkpoint: str | None = None, conf_threshold: float = 1.5,
                 *, device="cuda", **kw):
        super().__init__(camera, device=device)
        from pyslam_tpu_torch.models.dust3r import Dust3rModel

        self.model = Dust3rModel(checkpoint=checkpoint, device=self.device)
        self.conf_threshold = conf_threshold

    def _pair(self, img1, img2):
        """Host (pts1, conf1, pts2_in_1, conf2) of one pair."""
        return tuple(o.cpu().numpy() for o in self.model.infer_pair(img1, img2))

    def infer(self, images) -> SceneFromViewsResult:
        poses = [np.eye(4)]
        clouds = []
        prev_pts1 = None
        T_w_prev = np.eye(4)
        for i in range(len(images) - 1):
            pts1, conf1, pts2, conf2 = self._pair(images[i], images[i + 1])
            # register this pair's frame into the world through view i
            T_w = T_w_prev @ _umeyama_T(pts1, prev_pts1) if prev_pts1 is not None else np.eye(4)
            for pts, conf in ((pts1, conf1), (pts2, conf2)):
                p = pts[conf > self.conf_threshold]
                clouds.append(p @ T_w[:3, :3].T + T_w[:3, 3])
            poses.append(T_w)
            prev_pts1 = pts2
            T_w_prev = T_w
        return SceneFromViewsResult(poses=np.stack(poses), points=_concat(clouds))


class SceneFromViewsMast3r(SceneFromViewsDust3r):
    """MASt3R-class reconstruction (``models.mast3r``): the same pairwise
    pointmap chaining on MASt3R's pointmaps."""

    def __init__(self, camera=None, checkpoint: str | None = None, conf_threshold: float = 1.5,
                 *, device="cuda", **kw):
        SceneFromViewsBase.__init__(self, camera, device=device)
        from pyslam_tpu_torch.models.mast3r import Mast3rModel

        self.model = Mast3rModel(checkpoint=checkpoint, device=self.device)
        self.conf_threshold = conf_threshold

    def _pair(self, img1, img2):
        (p1, c1, _, _), (p2, c2, _, _) = self.model.infer_pair(img1, img2)
        return tuple(o.cpu().numpy() for o in (p1, c1, p2, c2))


class SceneFromViewsVGGT(SceneFromViewsBase):
    """VGGT one-pass reconstruction (``models.vggt``); ``robust`` drops the
    views whose anchor-attention mass falls under the lower of the
    ``anchor_mass_quantile`` quantile and half the median (Robust-VGGT)."""

    def __init__(self, camera=None, checkpoint: str | None = None, conf_threshold: float = 1.5,
                 robust: bool = False, anchor_mass_quantile: float = 0.2, *, device="cuda",
                 **kw):
        super().__init__(camera, device=device)
        from pyslam_tpu_torch.models.vggt import VGGTModel

        self.model = VGGTModel(checkpoint=checkpoint, device=self.device)
        self.conf_threshold = conf_threshold
        self.robust = robust
        self.anchor_mass_quantile = anchor_mass_quantile

    def kept_views(self, anchor_mass: np.ndarray) -> np.ndarray:
        keep = np.ones(len(anchor_mass), bool)
        if self.robust and len(anchor_mass) > 2:
            mass = anchor_mass[1:]
            thr = np.quantile(mass, self.anchor_mass_quantile)
            keep[1:] = mass >= min(thr, np.median(mass) * 0.5)
        return keep

    def infer(self, images) -> SceneFromViewsResult:
        out = self.model.infer_views(images)
        keep = self.kept_views(out["anchor_mass"])
        clouds = [out["points"][v][out["conf"][v] > self.conf_threshold]
                  for v in range(len(images)) if keep[v]]
        return SceneFromViewsResult(poses=out["poses"], points=_concat(clouds))


class SceneFromViewsFast3r(SceneFromViewsBase):
    """Fast3R one-pass reconstruction (``models.fast3r``)."""

    def __init__(self, camera=None, checkpoint: str | None = None, conf_threshold: float = 1.5,
                 *, device="cuda", **kw):
        super().__init__(camera, device=device)
        from pyslam_tpu_torch.models.fast3r import Fast3RModel

        self.model = Fast3RModel(checkpoint=checkpoint, device=self.device)
        self.conf_threshold = conf_threshold

    def infer(self, images) -> SceneFromViewsResult:
        out = self.model.infer_views(images)
        V = len(images)
        clouds = [out["points"][v][out["conf"][v] > self.conf_threshold] for v in range(V)]
        poses = []
        for v in range(V):
            # each view's pose from its local onto its global pointmap
            try:
                T = _umeyama_T(out["local_points"][v], out["points"][v])
            except Exception:
                T = np.eye(4)
            poses.append(T)
        return SceneFromViewsResult(poses=np.stack(poses), points=_concat(clouds))


class SceneFromViewsMVDust3r(SceneFromViewsBase):
    """MV-DUSt3R(+) one-pass reconstruction (``models.mvdust3r``): every
    view's pointmap lands in the reference view's frame."""

    def __init__(self, camera=None, checkpoint: str | None = None, conf_threshold: float = 1.5,
                 num_refs: int = 1, *, device="cuda", **kw):
        super().__init__(camera, device=device)
        from pyslam_tpu_torch.models.mvdust3r import MVDust3rModel

        self.model = MVDust3rModel(checkpoint=checkpoint, num_refs=num_refs, device=self.device)
        self.conf_threshold = conf_threshold

    def infer(self, images) -> SceneFromViewsResult:
        out = self.model.infer_views(images)
        clouds = [out["points"][v][out["conf"][v] > self.conf_threshold]
                  for v in range(len(images))]
        return SceneFromViewsResult(poses=out["poses"], points=_concat(clouds))


class SceneFromViewsDepthAnythingV3(SceneFromViewsBase):
    """DA3 any-view reconstruction (``models.depth_anything_v3``): per-view
    depth and world-frame rays, cameras recovered from the rays, world
    points origin + depth * direction."""

    def __init__(self, camera=None, checkpoint: str | None = None, conf_threshold: float = 0.5,
                 *, device="cuda", **kw):
        super().__init__(camera, device=device)
        from pyslam_tpu_torch.models.depth_anything_v3 import DepthAnything3

        self.model = DepthAnything3(checkpoint=checkpoint, device=self.device)
        self.conf_threshold = conf_threshold

    def infer(self, images) -> SceneFromViewsResult:
        out = self.model.inference(images)
        clouds = [out["points"][v][out["conf"][v] > self.conf_threshold]
                  for v in range(len(images))]
        return SceneFromViewsResult(poses=out["poses"], points=_concat(clouds))


_BACKENDS = {
    SceneFromViewsType.GEOMETRIC: SceneFromViewsGeometric,
    SceneFromViewsType.DUST3R: SceneFromViewsDust3r,
    SceneFromViewsType.MAST3R: SceneFromViewsMast3r,
    SceneFromViewsType.MVDUST3R: SceneFromViewsMVDust3r,
    SceneFromViewsType.VGGT: SceneFromViewsVGGT,
    SceneFromViewsType.VGGT_ROBUST: SceneFromViewsVGGT,
    SceneFromViewsType.FAST3R: SceneFromViewsFast3r,
    SceneFromViewsType.DEPTH_ANYTHING_V3: SceneFromViewsDepthAnythingV3,
}


def scene_from_views_factory(scene_type=SceneFromViewsType.GEOMETRIC, camera=None, *,
                             device: torch.device | str = "cuda", **kw) -> SceneFromViewsBase:
    if isinstance(scene_type, str):
        scene_type = SceneFromViewsType(scene_type.lower())
    if scene_type == SceneFromViewsType.VGGT_ROBUST:
        kw.setdefault("robust", True)
    return _BACKENDS[scene_type](camera, device=device, **kw)
