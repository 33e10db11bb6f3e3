"""Depth estimator interface and factory (port of
``pyslam_tpu/depth_estimation/depth_estimator.py``).

``DepthEstimator.infer(img, img_right) -> (depth, pts3d)`` as in the
reference: a host (H, W) float32 depth with 0 where invalid, and the
back-projected points when a camera is given.  ``DEPTH_SGBM`` runs the
semi-global matcher of ``sgm.py`` and also offers ``infer_depth_device``
(the depth left on the device for the TSDF).  The learned estimators run
their network on the estimator's device (DepthAnythingV2, or the DPT-lite
with ``faithful=False``; DepthAnything 3; DepthPro; MV-DUSt3R; MASt3R;
RAFT-Stereo; CREStereo) and resample its map back to the input size on the
host by the reference's nearest index arithmetic.  ``raft_stereo`` and
``crestereo`` without a checkpoint route to SGM, as in the reference; with
one (the JAX package's ``.npz``) they run their network.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from pyslam_tpu_torch.depth_estimation.sgm import sgm_disparity
from pyslam_tpu_torch.utils.device import as_device_tensor


class DepthEstimatorType(enum.Enum):
    DEPTH_SGBM = "sgbm"
    DEPTH_ANYTHING_V2 = "depth_anything_v2"
    DEPTH_ANYTHING_V3 = "depth_anything_v3"
    DEPTH_PRO = "depth_pro"
    DEPTH_RAFT_STEREO = "raft_stereo"
    DEPTH_CRESTEREO_PYTORCH = "crestereo"
    DEPTH_CRESTEREO_MEGENGINE = "crestereo_megengine"
    DEPTH_MAST3R = "mast3r"
    DEPTH_MVDUST3R = "mvdust3r"


class DepthEstimator:
    """Base interface."""

    def __init__(self, camera=None, min_depth=0.1, max_depth=50.0, *,
                 device: torch.device | str = "cuda"):
        self.camera = camera
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.device = torch.device(device)

    def infer(self, img, img_right=None):
        """Returns (depth (H,W) float32 with 0 = invalid, pts3d or None)."""
        raise NotImplementedError

    def _depth_to_points(self, depth):
        if self.camera is None:
            return None
        h, w = depth.shape
        ys, xs = np.mgrid[0:h, 0:w]
        z = np.asarray(depth)
        ok = z > 0
        x = (xs - self.camera.cx) / self.camera.fx * z
        y = (ys - self.camera.cy) / self.camera.fy * z
        pts = np.stack([x, y, z], axis=-1)
        pts[~ok] = 0
        return pts


class DepthEstimatorSgbm(DepthEstimator):
    """Semi-global stereo matcher.

    ``downscale=s`` runs SGM at 1/s resolution (the mean of each s x s
    block, summed in the reference's order) with ``max(16, max_disparity // s)`` disparities, which keeps
    the metric depth range, and repeats each disparity back to full
    resolution (nearest); columns and rows the downscale cut off are
    invalid."""

    def __init__(self, camera=None, max_disparity: int = 64, downscale: int = 1, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(camera, device=device, **kw)
        self.max_disparity = max_disparity
        self.downscale = max(1, int(downscale))

    def _disparity_full_scale(self, img, img_right) -> torch.Tensor:
        """Disparity at full resolution, in full-resolution pixels, on the
        estimator's device."""
        iml = as_device_tensor(img, self.device)
        imr = as_device_tensor(img_right, self.device)
        s = self.downscale
        if s == 1:
            return sgm_disparity(iml, imr, max_disp=self.max_disparity)
        h, w = iml.shape
        hs, ws = h // s, w // s

        def pool(x):
            # the block's sum in row-major order, then a multiply by the
            # float32 reciprocal of its size, as XLA's CPU code computes the
            # reference's mean (torch's mean sums in another order)
            blocks = x[:hs * s, :ws * s].reshape(hs, s, ws, s)
            acc = blocks[:, 0, :, 0]
            for k in range(1, s * s):
                acc = acc + blocks[:, k // s, :, k % s]
            return acc * float(np.float32(1.0) / np.float32(s * s))

        disp_s = sgm_disparity(pool(iml), pool(imr), max_disp=max(16, self.max_disparity // s))
        disp = disp_s.repeat_interleave(s, 0).repeat_interleave(s, 1)
        disp = torch.nn.functional.pad(disp, (0, w - ws * s, 0, h - hs * s), value=-1.0)
        return torch.where(disp > 0, disp * s, disp.new_full((), -1.0))

    def infer_depth_device(self, img, img_right=None) -> torch.Tensor:
        """Depth (H,W) float32 on the estimator's device, 0 where invalid,
        with no copy to the host (the TSDF integrator consumes it there)."""
        assert img_right is not None, "SGBM needs a stereo pair"
        disp = self._disparity_full_scale(img, img_right)
        zero = disp.new_zeros(())
        if self.camera is not None and self.camera.bf > 0:
            bf = torch.full((), self.camera.bf, dtype=torch.float32, device=disp.device)
            depth = torch.where(disp > 0, bf / torch.clamp(disp, min=1e-6), zero)
            return torch.where((depth > self.min_depth) & (depth < self.max_depth), depth, zero)
        return torch.where(disp > 0, disp, zero)

    def infer(self, img, img_right=None):
        depth = self.infer_depth_device(img, img_right).cpu().numpy()
        return depth, self._depth_to_points(depth)


def _nearest_to(d: np.ndarray, hw) -> np.ndarray:
    """A network-resolution map (h, w) -> (H, W) by the reference's nearest
    index arithmetic, ``floor(i * h / H)``."""
    h, w = hw
    mh, mw = d.shape
    ys = np.clip((np.arange(h) * mh / h).astype(int), 0, mh - 1)
    xs = np.clip((np.arange(w) * mw / w).astype(int), 0, mw - 1)
    return d[np.ix_(ys, xs)]


class DepthEstimatorDepthAnything(DepthEstimator):
    """DepthAnythingV2 (``models.depth_anything_v2``) when ``faithful``, the
    DPT-lite (``models.depth_anything``) otherwise; the relative inverse
    depth normalised to [0, 1] becomes ``max_depth * (1 - rel)``."""

    def __init__(self, camera=None, checkpoint: str | None = None, faithful: bool = True, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(camera, device=device, **kw)
        if faithful:
            from pyslam_tpu_torch.models.depth_anything_v2 import DepthAnythingV2

            self.model = DepthAnythingV2(checkpoint=checkpoint, device=self.device)
        else:
            from pyslam_tpu_torch.models.depth_anything import DepthAnythingInference

            self.model = DepthAnythingInference(checkpoint=checkpoint, device=self.device)

    def infer(self, img, img_right=None):
        rel = self.model.infer(img)
        rel = rel / max(float(rel.max()), 1e-9)
        depth = np.where(rel > 1e-6, self.max_depth * (1.0 - rel), 0.0)
        return depth.astype(np.float32), self._depth_to_points(depth)


class DepthEstimatorDepthAnythingV3(DepthEstimator):
    """DEPTH_ANYTHING_V3: the DA3 any-view model (``models.depth_anything_v3``)
    on one view, its depth clipped to [0, max_depth] (the network alone:
    the reference's camera recovery from the rays, unused here, is
    skipped)."""

    def __init__(self, camera=None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(camera, device=device, **kw)
        from pyslam_tpu_torch.models.depth_anything_v3 import DepthAnything3

        self.model = DepthAnything3(checkpoint=checkpoint, device=self.device)

    def infer(self, img, img_right=None):
        d = self.model.run([img])[0][0].cpu().numpy()
        depth = np.clip(_nearest_to(d, np.asarray(img).shape[:2]), 0.0, self.max_depth)
        depth = depth.astype(np.float32)
        return depth, self._depth_to_points(depth)


class DepthEstimatorMVDust3r(DepthEstimator):
    """DEPTH_MVDUST3R: the z of MV-DUSt3R's local pointmap of view 0
    (``models.mvdust3r``); (img, img_right) are two views when a right
    image is given."""

    def __init__(self, camera=None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(camera, device=device, **kw)
        from pyslam_tpu_torch.models.mvdust3r import MVDust3rModel

        self.model = MVDust3rModel(checkpoint=checkpoint, device=self.device)

    def infer(self, img, img_right=None):
        views = [img] if img_right is None else [img, img_right]
        d = self.model.infer_views(views)["local_points"][0][..., 2]
        depth = np.clip(_nearest_to(d, np.asarray(img).shape[:2]), 0.0, self.max_depth)
        depth = depth.astype(np.float32)
        return depth, self._depth_to_points(depth)


class DepthEstimatorDepthPro(DepthEstimator):
    """DEPTH_PRO: DepthPro's metric depth (``models.depth_pro``), with the
    calibrated focal when there is a camera, else the FOV head's."""

    def __init__(self, camera=None, checkpoint: str | None = None, cfg=None, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(camera, device=device, **kw)
        from pyslam_tpu_torch.models.depth_pro import DepthPro

        self.model = DepthPro(cfg=cfg, checkpoint=checkpoint, device=self.device)

    def infer(self, img, img_right=None):
        f_px = self.camera.fx if self.camera is not None else None
        depth, _ = self.model.infer(img, f_px=f_px)
        depth = np.clip(depth, 0.0, self.max_depth).astype(np.float32)
        return depth, self._depth_to_points(depth)


class DepthEstimatorRaft(DepthEstimator):
    """RAFT-class recurrent stereo (``models.raft_stereo``): ``bf / disp``
    where the disparity passes 0.5 px (``bf`` 50 without a camera)."""

    def __init__(self, camera=None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(camera, device=device, **kw)
        from pyslam_tpu_torch.models.raft_stereo import RaftStereo

        self.model = RaftStereo(checkpoint=checkpoint, device=self.device)

    def infer(self, img, img_right=None):
        assert img_right is not None, "stereo estimator needs a right image"
        disp = self.model.infer(img, img_right)
        bf = self.camera.bf if self.camera is not None else 50.0
        with np.errstate(divide="ignore"):
            depth = np.where(disp > 0.5, bf / np.maximum(disp, 1e-6), 0.0)
        depth = np.clip(depth, 0.0, self.max_depth).astype(np.float32)
        return depth, self._depth_to_points(depth)


class DepthEstimatorCREStereo(DepthEstimatorRaft):
    """CREStereo-class cascaded recurrent stereo (``models.crestereo``), the
    depth as RAFT's."""

    def __init__(self, camera=None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda", **kw):
        DepthEstimator.__init__(self, camera, device=device, **kw)
        from pyslam_tpu_torch.models.crestereo import CREStereo

        self.model = CREStereo(checkpoint=checkpoint, device=self.device)


class DepthEstimatorMast3r(DepthEstimator):
    """DEPTH_MAST3R: the z of MASt3R's view-1 pointmap (``models.mast3r``);
    the pair is (img, img_right), or the image with itself."""

    def __init__(self, camera=None, checkpoint: str | None = None, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(camera, device=device, **kw)
        from pyslam_tpu_torch.models.mast3r import Mast3rModel

        self.model = Mast3rModel(checkpoint=checkpoint, device=self.device)

    def infer(self, img, img_right=None):
        other = img_right if img_right is not None else img
        (pts1, _, _, _), _ = self.model.infer_pair(img, other)
        d = pts1[..., 2].cpu().numpy().astype(np.float32)
        depth = np.clip(_nearest_to(d, np.asarray(img).shape[:2]), 0.0, self.max_depth)
        return depth, self._depth_to_points(depth)


_STEREO_NETS = {DepthEstimatorType.DEPTH_RAFT_STEREO,
                DepthEstimatorType.DEPTH_CRESTEREO_PYTORCH,
                DepthEstimatorType.DEPTH_CRESTEREO_MEGENGINE}
_ESTIMATORS = {DepthEstimatorType.DEPTH_SGBM: DepthEstimatorSgbm,
               DepthEstimatorType.DEPTH_ANYTHING_V2: DepthEstimatorDepthAnything,
               DepthEstimatorType.DEPTH_ANYTHING_V3: DepthEstimatorDepthAnythingV3,
               DepthEstimatorType.DEPTH_PRO: DepthEstimatorDepthPro,
               DepthEstimatorType.DEPTH_MVDUST3R: DepthEstimatorMVDust3r,
               DepthEstimatorType.DEPTH_MAST3R: DepthEstimatorMast3r}


def depth_estimator_factory(depth_estimator_type=DepthEstimatorType.DEPTH_SGBM, camera=None,
                            max_depth: float = 50.0, *, device: torch.device | str = "cuda",
                            **kw) -> DepthEstimator:
    t = depth_estimator_type
    if isinstance(t, str):
        t = DepthEstimatorType(t.lower())
    if t in _STEREO_NETS:
        if kw.get("checkpoint"):
            cls = DepthEstimatorRaft if t == DepthEstimatorType.DEPTH_RAFT_STEREO \
                else DepthEstimatorCREStereo
            return cls(camera, max_depth=max_depth, device=device, **kw)
        # without weights the reference routes the stereo networks to SGM
        kw.pop("checkpoint", None)
        t = DepthEstimatorType.DEPTH_SGBM
    if t not in _ESTIMATORS:
        raise NotImplementedError(f"depth estimator {t}")
    return _ESTIMATORS[t](camera, max_depth=max_depth, device=device, **kw)
