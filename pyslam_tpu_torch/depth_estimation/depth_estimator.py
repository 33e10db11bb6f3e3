"""Depth estimator interface and factory (port of
``pyslam_tpu/depth_estimation/depth_estimator.py``, the SGBM path).

``DepthEstimator.infer(img, img_right) -> (depth, pts3d)`` as in the
reference.  ``DEPTH_SGBM`` runs the semi-global matcher of ``sgm.py`` on the
estimator's device; ``raft_stereo`` and ``crestereo`` without a checkpoint
route to it, as in the reference.  The learned estimators are not ported
(ROADMAP.md item 11).
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


_LEARNED = {DepthEstimatorType.DEPTH_ANYTHING_V2, DepthEstimatorType.DEPTH_ANYTHING_V3,
            DepthEstimatorType.DEPTH_PRO, DepthEstimatorType.DEPTH_MAST3R,
            DepthEstimatorType.DEPTH_MVDUST3R}
_STEREO_NETS = {DepthEstimatorType.DEPTH_RAFT_STEREO,
                DepthEstimatorType.DEPTH_CRESTEREO_PYTORCH,
                DepthEstimatorType.DEPTH_CRESTEREO_MEGENGINE}


def depth_estimator_factory(depth_estimator_type=DepthEstimatorType.DEPTH_SGBM, camera=None,
                            max_depth: float = 50.0, *, device: torch.device | str = "cuda",
                            **kw) -> DepthEstimator:
    t = depth_estimator_type
    if isinstance(t, str):
        t = DepthEstimatorType(t.lower())
    if t in _STEREO_NETS:
        if kw.get("checkpoint"):
            raise NotImplementedError(
                f"depth estimator {t.name} with a checkpoint is not ported yet "
                "(ROADMAP.md item 11)")
        # without weights the reference routes the stereo networks to SGM
        kw.pop("checkpoint", None)
        t = DepthEstimatorType.DEPTH_SGBM
    if t == DepthEstimatorType.DEPTH_SGBM:
        return DepthEstimatorSgbm(camera, max_depth=max_depth, device=device, **kw)
    if t in _LEARNED:
        raise NotImplementedError(f"depth estimator {t.name} is not ported yet "
                                  "(ROADMAP.md item 11)")
    raise NotImplementedError(f"depth estimator {t}")
