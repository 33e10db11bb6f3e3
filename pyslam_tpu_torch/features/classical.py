"""Classical extractors: Shi-Tomasi corners on the device, SIFT and
RootSIFT through OpenCV on the host (port of
``pyslam_tpu/features/classical.py``).

SIFT detection is host work in the reference as well: cv2 runs on the host
and its keypoints and descriptors land in the same fixed-shape
``FeatureData`` the rest of the pipeline consumes, uploaded to the
extractor's device.  ``cv2`` is imported when a SIFT extractor is built; a
host without it raises ``ImportError`` naming the preset.  RootSIFT maps
each descriptor to sqrt(des / ||des||_1) (the Hellinger kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from pyslam_tpu_torch.features.orb2 import FeatureData
from pyslam_tpu_torch.ops import image as image_ops
from pyslam_tpu_torch.ops import nms as nms_ops


class CvSIFTExtractor:
    """cv2.SIFT wrapped to the fixed-shape FeatureData contract on
    ``device`` (the card unless the caller asks for another)."""

    def __init__(self, num_features: int = 2000, num_levels: int = 16,
                 scale_factor: float = 1.2, root_sift: bool = False, *,
                 device: torch.device | str = "cuda"):
        name = "ROOT_SIFT" if root_sift else "SIFT"
        try:
            import cv2
        except ImportError as e:
            raise ImportError(f"the {name} preset needs OpenCV (cv2) on the host: {e}") from e
        self.num_features = num_features
        self.num_levels = num_levels
        self.scale_factor = scale_factor
        self.root_sift = root_sift
        self.device = torch.device(device)
        self._sift = cv2.SIFT_create(nfeatures=num_features)
        self.scale_factors = (scale_factor ** np.arange(num_levels)).astype(np.float32)
        self.sigma2 = (self.scale_factors ** 2).astype(np.float32)
        self.inv_sigma2 = 1.0 / self.sigma2

    def _level_from_size(self, sizes: np.ndarray) -> np.ndarray:
        """The continuous SIFT size mapped onto the discrete sigma pyramid
        of the SLAM matching gates."""
        base = 3.2  # SIFT base keypoint diameter (2 * 1.6 sigma)
        lv = np.round(np.log(np.maximum(sizes, base) / base) / np.log(self.scale_factor))
        return np.clip(lv, 0, self.num_levels - 1).astype(np.int32)

    def host_features(self, img):
        """cv2 detection and description -> the FeatureData fields as host
        numpy arrays (the reference's ``__call__`` before its upload)."""
        import cv2

        img8 = np.asarray(img)
        if img8.dtype != np.uint8:
            img8 = np.clip(img8, 0, 255).astype(np.uint8)
        if img8.ndim == 3:
            img8 = cv2.cvtColor(img8, cv2.COLOR_BGR2GRAY)
        kps, des = self._sift.detectAndCompute(img8, None)
        n = self.num_features
        xy = np.zeros((n, 2), np.float32)
        level = np.zeros((n,), np.int32)
        angle = np.zeros((n,), np.float32)
        size = np.full((n,), 3.2, np.float32)
        resp = np.zeros((n,), np.float32)
        desc = np.zeros((n, 128), np.float32)
        valid = np.zeros((n,), bool)
        if kps:
            k = min(len(kps), n)
            order = np.argsort([-p.response for p in kps])[:k]
            xy[:k] = [kps[i].pt for i in order]
            angle[:k] = [kps[i].angle for i in order]
            size[:k] = [kps[i].size for i in order]
            resp[:k] = [kps[i].response for i in order]
            level[:k] = self._level_from_size(size[:k])
            d = des[order].astype(np.float32)
            if self.root_sift:
                d = np.sqrt(d / np.maximum(np.abs(d).sum(axis=1, keepdims=True), 1e-7))
            desc[:k] = d
            valid[:k] = True
        return xy, level, angle, size, resp, desc, valid

    def __call__(self, img) -> FeatureData:
        xy, level, angle, size, resp, desc, valid = self.host_features(img)
        dev = self.device
        return FeatureData(
            xy=torch.as_tensor(xy).to(dev), level=torch.as_tensor(level.astype(np.int64)).to(dev),
            angle=torch.as_tensor(angle).to(dev), size=torch.as_tensor(size).to(dev),
            response=torch.as_tensor(resp).to(dev), desc=torch.as_tensor(desc).to(dev),
            valid=torch.as_tensor(valid).to(dev))


class ShiTomasiExtractor:
    """Shi-Tomasi (minimum-eigenvalue) corners on ``device``: the smaller
    eigenvalue of the structure tensor of Gaussian-windowed Sobel
    gradients, selected by grid top-k.  The LK tracker's seed detector; it
    carries no descriptor (a (N, 1) zero block)."""

    def __init__(self, num_features: int = 1000, nms_cell: int = 8,
                 window_sigma: float = 1.5, *, device: torch.device | str = "cuda"):
        self.num_features = num_features
        self.nms_cell = nms_cell
        self.window_sigma = window_sigma
        self.device = torch.device(device)
        self.scale_factors = np.array([1.0], np.float32)
        self.sigma2 = np.array([1.0], np.float32)
        self.inv_sigma2 = 1.0 / self.sigma2

    def score(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W) image -> (H, W) minimum-eigenvalue response."""
        gx, gy = image_ops.sobel_gradients(img * float(np.float32(1.0 / 255.0)))
        ws = self.window_sigma
        sxx = image_ops.gaussian_blur(gx * gx, sigma=ws)
        syy = image_ops.gaussian_blur(gy * gy, sigma=ws)
        sxy = image_ops.gaussian_blur(gx * gy, sigma=ws)
        tr = 0.5 * (sxx + syy)
        half = 0.5 * (sxx - syy)
        det = torch.sqrt(torch.clamp(half * half + sxy * sxy, min=0.0).double()).float()
        return tr - det

    def extract(self, img: torch.Tensor) -> FeatureData:
        n = self.num_features
        dev = img.device
        xy, resp, valid = nms_ops.grid_topk_keypoints(self.score(img)[None],
                                                      cell=self.nms_cell, per_cell=4, max_out=n)
        return FeatureData(
            xy=xy[0], level=torch.zeros(n, dtype=torch.int64, device=dev),
            angle=torch.zeros(n, dtype=torch.float32, device=dev),
            size=torch.full((n,), 10.0, dtype=torch.float32, device=dev),
            response=resp[0], desc=torch.zeros((n, 1), dtype=torch.float32, device=dev),
            valid=valid[0])

    def __call__(self, img) -> FeatureData:
        return self.extract(image_ops.gray_image(img, self.device))
