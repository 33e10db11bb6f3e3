"""Feature trackers: detector + descriptor + matcher bundles and their
presets (port of ``pyslam_tpu/features/tracker.py``).

Every preset that needs no learned weights runs: ORB2 / ORB2_BF / ORB /
FAST_ORB (FAST + rBRIEF), BRISK / ORB2_FREAK / ORB2_BEBLID (the ORB2
detector re-described with 512-bit patterns), SURF, KAZE, AKAZE, SIFT and
ROOT_SIFT (cv2 on the host), and the Lucas-Kanade trackers LK_FAST and
LK_SHI_TOMASI (``LkFeatureTracker.track_lk``).  The learned presets
(SuperPoint, the patch-descriptor networks, LightGlue, MASt3R, LoFTR and the
rest) raise ``ValueError``: they come with the learned-model slice.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from pyslam_tpu_torch.features.matcher import (
    FeatureMatcher,
    FeatureMatcherTypes,
    feature_matcher_factory,
)
from pyslam_tpu_torch.features.orb2 import FeatureData, ORB2Extractor
from pyslam_tpu_torch.features.types import (
    FEATURE_INFO,
    PATCH_DESCRIPTOR_TYPES,
    FeatureDescriptorTypes,
    FeatureDetectorTypes,
    NormType,
)

LEARNED_SLICE = "the learned-model slice (ROADMAP item 3, learned models with bundled weights)"


class FeatureTrackerTypes(enum.Enum):
    DES_BF = 0    # descriptor matching, brute force (default)
    DES_NN = 1
    LK = 2        # Lucas-Kanade optical flow (pyramidal)
    XFEAT = 3
    LIGHTGLUE = 4
    MAST3R = 5    # dense two-view matcher
    LOFTR = 6     # detector-free transformer matcher


@dataclass
class FeatureTrackerConfig:
    name: str = "ORB2"
    detector_type: FeatureDetectorTypes = FeatureDetectorTypes.ORB2
    descriptor_type: FeatureDescriptorTypes = FeatureDescriptorTypes.ORB2
    tracker_type: FeatureTrackerTypes = FeatureTrackerTypes.DES_BF
    num_features: int = 2000
    num_levels: int = 8
    scale_factor: float = 1.2
    ratio_test: float = 0.75
    extra: dict = field(default_factory=dict)

    def to_json(self):
        return {
            "name": self.name,
            "detector_type": self.detector_type.name,
            "descriptor_type": self.descriptor_type.name,
            "tracker_type": self.tracker_type.name,
            "num_features": self.num_features,
            "num_levels": self.num_levels,
            "scale_factor": self.scale_factor,
            "ratio_test": self.ratio_test,
        }

    @staticmethod
    def from_json(d):
        return FeatureTrackerConfig(
            name=d.get("name", "ORB2"),
            detector_type=FeatureDetectorTypes[d.get("detector_type", "ORB2")],
            descriptor_type=FeatureDescriptorTypes[d.get("descriptor_type", "ORB2")],
            tracker_type=FeatureTrackerTypes[d.get("tracker_type", "DES_BF")],
            num_features=d.get("num_features", 2000),
            num_levels=d.get("num_levels", 8),
            scale_factor=d.get("scale_factor", 1.2),
            ratio_test=d.get("ratio_test", 0.75),
        )


def _cfg(name, detector=FeatureDetectorTypes.ORB2, descriptor=FeatureDescriptorTypes.ORB2,
         tracker=FeatureTrackerTypes.DES_BF, **kw) -> FeatureTrackerConfig:
    return FeatureTrackerConfig(name=name, detector_type=detector, descriptor_type=descriptor,
                                tracker_type=tracker, **kw)


_D = FeatureDetectorTypes
_S = FeatureDescriptorTypes
_T = FeatureTrackerTypes


class FeatureTrackerConfigs:
    """The reference's preset registry (the same names and settings)."""

    ORB2 = _cfg("ORB2")
    ORB2_BF = _cfg("ORB2_BF")
    ORB = _cfg("ORB", num_levels=8)
    FAST_ORB = _cfg("FAST_ORB", _D.FAST)
    LK_FAST = _cfg("LK_FAST", _D.FAST, tracker=_T.LK, num_levels=3)
    LK_SHI_TOMASI = _cfg("LK_SHI_TOMASI", _D.SHI_TOMASI, tracker=_T.LK, num_features=1000,
                         num_levels=1)
    SUPERPOINT = _cfg("SUPERPOINT", _D.SUPERPOINT, _S.SUPERPOINT, num_features=1000,
                      num_levels=1, ratio_test=0.8)
    XFEAT = _cfg("XFEAT", _D.XFEAT, _S.XFEAT, num_levels=1, ratio_test=0.8)
    LIGHTGLUE = _cfg("LIGHTGLUE", _D.SUPERPOINT, _S.SUPERPOINT, _T.LIGHTGLUE,
                     num_features=1000, num_levels=1, extra={"desc_dim": 256})
    D2NET = _cfg("D2NET", _D.D2NET, _S.D2NET, num_levels=1, ratio_test=0.8)
    KEYNET = _cfg("KEYNET", _D.KEYNET, _S.HARDNET, num_levels=1, ratio_test=0.8)
    KEYNETAFFNETHARDNET = _cfg("KEYNETAFFNETHARDNET", _D.KEYNET, _S.HARDNET, num_levels=1,
                               ratio_test=0.8)
    LOFTR = _cfg("LOFTR", tracker=_T.LOFTR, num_features=1024, num_levels=1)
    MAST3R = _cfg("MAST3R", descriptor=_S.MAST3R, tracker=_T.MAST3R, num_levels=1,
                  ratio_test=0.9)
    DISK = _cfg("DISK", _D.DISK, _S.DISK, num_levels=1, ratio_test=0.8)
    ALIKED = _cfg("ALIKED", _D.ALIKED, _S.ALIKED, num_levels=1, ratio_test=0.8)
    R2D2 = _cfg("R2D2", _D.R2D2, _S.R2D2, num_levels=1, ratio_test=0.8)
    SIFT = _cfg("SIFT", _D.SIFT, _S.SIFT, num_levels=16)
    ROOT_SIFT = _cfg("ROOT_SIFT", _D.ROOT_SIFT, _S.ROOT_SIFT, num_levels=16)
    ORB2_HARDNET = _cfg("ORB2_HARDNET", descriptor=_S.HARDNET)
    ORB2_SOSNET = _cfg("ORB2_SOSNET", descriptor=_S.SOSNET)
    ORB2_L2NET = _cfg("ORB2_L2NET", descriptor=_S.L2NET)
    ORB2_TFEAT = _cfg("ORB2_TFEAT", descriptor=_S.TFEAT)
    SHI_TOMASI_HARDNET = _cfg("SHI_TOMASI_HARDNET", _D.SHI_TOMASI, _S.HARDNET,
                              num_features=1000, num_levels=1)
    SURF = _cfg("SURF", _D.SURF, _S.SURF, num_features=1000, num_levels=1, ratio_test=0.8)
    KAZE = _cfg("KAZE", _D.KAZE, _S.KAZE, num_features=1000, num_levels=1, ratio_test=0.8)
    AKAZE = _cfg("AKAZE", _D.AKAZE, _S.AKAZE, num_features=1000, num_levels=1)
    LIGHTGLUE_DISK = _cfg("LIGHTGLUE_DISK", _D.DISK, _S.DISK, _T.LIGHTGLUE, num_levels=1,
                          extra={"desc_dim": 128})
    LIGHTGLUE_ALIKED = _cfg("LIGHTGLUE_ALIKED", _D.ALIKED, _S.ALIKED, _T.LIGHTGLUE,
                            num_levels=1, extra={"desc_dim": 128})
    LIGHTGLUE_SIFT = _cfg("LIGHTGLUE_SIFT", _D.SIFT, _S.SIFT, _T.LIGHTGLUE, num_levels=16,
                          extra={"desc_dim": 128})
    BRISK = _cfg("BRISK", descriptor=_S.BRISK)        # FAST-pyramid detector (AGAST-class)
    ORB2_FREAK = _cfg("ORB2_FREAK", descriptor=_S.FREAK)
    ORB2_BEBLID = _cfg("ORB2_BEBLID", descriptor=_S.BEBLID)
    ORB2_GEODESC = _cfg("ORB2_GEODESC", descriptor=_S.GEODESC)
    GEODESC = _cfg("GEODESC", descriptor=_S.GEODESC)
    LOGPOLAR = _cfg("LOGPOLAR", descriptor=_S.LOGPOLAR)
    CONTEXTDESC = _cfg("CONTEXTDESC", _D.SIFT, _S.CONTEXTDESC, num_levels=16, ratio_test=0.8)
    LFNET = _cfg("LFNET", _D.LFNET, _S.LFNET, num_features=1000, num_levels=1, ratio_test=0.8)
    DELF = _cfg("DELF", _D.DELF, _S.DELF, num_features=1000, num_levels=1, ratio_test=0.8)
    XFEAT_LIGHTGLUE = _cfg("XFEAT_LIGHTGLUE", _D.XFEAT, _S.XFEAT, _T.LIGHTGLUE, num_levels=1,
                           extra={"desc_dim": 64})

    @staticmethod
    def get(name: str) -> FeatureTrackerConfig:
        cfg = getattr(FeatureTrackerConfigs, name, None)
        if not isinstance(cfg, FeatureTrackerConfig):
            raise KeyError(f"unknown tracker preset {name}")
        return cfg


# the presets that run without learned weights
WEIGHT_FREE_PRESETS = ("ORB2", "ORB2_BF", "ORB", "FAST_ORB", "LK_FAST", "LK_SHI_TOMASI",
                       "SIFT", "ROOT_SIFT", "SURF", "KAZE", "AKAZE", "BRISK", "ORB2_FREAK",
                       "ORB2_BEBLID")


def _learned(config: FeatureTrackerConfig, what: str) -> ValueError:
    return ValueError(f"feature tracker preset {config.name}: {what} needs learned weights; "
                      f"it comes with {LEARNED_SLICE}")


def _make_extractor(config: FeatureTrackerConfig, device: torch.device):
    """The detector's extractor and the norm of its own descriptor."""
    det = config.detector_type
    if det in (_D.ORB2, _D.FAST):
        return ORB2Extractor(num_features=config.num_features, num_levels=config.num_levels,
                             scale_factor=config.scale_factor, device=device), NormType.HAMMING
    if det == _D.SHI_TOMASI:
        from pyslam_tpu_torch.features.classical import ShiTomasiExtractor

        return ShiTomasiExtractor(num_features=config.num_features, device=device), NormType.L2
    if det in (_D.SIFT, _D.ROOT_SIFT):
        from pyslam_tpu_torch.features.classical import CvSIFTExtractor

        return CvSIFTExtractor(num_features=config.num_features, scale_factor=config.scale_factor,
                               root_sift=det == _D.ROOT_SIFT, device=device), NormType.L2
    if det == _D.SURF:
        from pyslam_tpu_torch.features.surf import SurfExtractor

        return SurfExtractor(num_features=config.num_features, device=device), NormType.L2
    if det in (_D.KAZE, _D.AKAZE):
        from pyslam_tpu_torch.features.akaze import AkazeExtractor

        kaze = det == _D.KAZE
        return (AkazeExtractor(num_features=config.num_features,
                               descriptor="KAZE" if kaze else "MLDB", device=device),
                NormType.L2 if kaze else NormType.HAMMING)
    raise _learned(config, f"the {det.name} detector")


class FeatureTracker:
    """Detector + descriptor + matcher bundle on ``device`` (the card
    unless the caller asks for another)."""

    def __init__(self, config: FeatureTrackerConfig, *, device: torch.device | str = "cuda"):
        if config.tracker_type in (_T.LIGHTGLUE, _T.XFEAT, _T.MAST3R, _T.LOFTR):
            raise _learned(config, f"the {config.tracker_type.name} matcher")
        desc = config.descriptor_type
        if desc in PATCH_DESCRIPTOR_TYPES or desc == _S.CONTEXTDESC:
            raise _learned(config, f"the {desc.name} descriptor")
        self.config = config
        self.device = torch.device(device)
        self.num_features = config.num_features
        self.num_levels = config.num_levels
        self.scale_factor = config.scale_factor
        self.extractor, self.norm = _make_extractor(config, self.device)
        if desc in (_S.BRISK, _S.FREAK, _S.BEBLID):
            from pyslam_tpu_torch.features.binary_descriptors import BinaryDescribedExtractor

            self.extractor = BinaryDescribedExtractor(self.extractor, desc.name)
            self.norm = NormType.HAMMING
        info = FEATURE_INFO.get(desc)
        mtype = (FeatureMatcherTypes.NN if config.tracker_type == _T.DES_NN
                 else FeatureMatcherTypes.BF)
        self.matcher: FeatureMatcher = feature_matcher_factory(
            norm=self.norm, matcher_type=mtype,
            max_distance=info.max_distance if info else None, ratio_test=config.ratio_test)
        self.scale_factors = self.extractor.scale_factors
        self.sigma2 = self.extractor.sigma2
        self.inv_sigma2 = 1.0 / self.sigma2

    def detectAndCompute(self, img) -> FeatureData:
        """One (H, W) image -> FeatureData on ``device``."""
        return self.extractor(img)

    def match(self, f1: FeatureData, f2: FeatureData, ratio: float | None = None):
        """Match two FeatureData with the preset's matcher; returns (idx1,
        idx2) host arrays."""
        idx2, _ = self.matcher.match(f1.desc, f2.desc, valid1=f1.valid, valid2=f2.valid,
                                     ratio=ratio)
        idx2 = idx2.cpu().numpy()
        idx1 = np.nonzero(idx2 >= 0)[0]
        return idx1, idx2[idx1]


class LkFeatureTracker(FeatureTracker):
    """Lucas-Kanade tracker: detect once, then track keypoints frame to
    frame with pyramidal LK (``ops.lk``) instead of descriptor matching."""

    def track_lk(self, img0, img1, pts0):
        """(pts1, ok_mask, residuals) host arrays for (N, 2) points tracked
        from img0 to img1 on the tracker's device."""
        from pyslam_tpu_torch.ops import lk as lk_ops

        dev = self.device

        def up(x):
            return torch.as_tensor(np.asarray(x, np.float32)).to(dev)

        pts1, ok, res = lk_ops.lk_track_pyramidal(up(img0), up(img1), up(pts0))
        return pts1.cpu().numpy(), ok.cpu().numpy(), res.cpu().numpy()


def feature_tracker_factory(config: FeatureTrackerConfig | str = "ORB2", *,
                            device: torch.device | str = "cuda") -> FeatureTracker:
    if isinstance(config, str):
        config = FeatureTrackerConfigs.get(config)
    if config.tracker_type == _T.LK:
        return LkFeatureTracker(config, device=device)
    return FeatureTracker(config, device=device)
