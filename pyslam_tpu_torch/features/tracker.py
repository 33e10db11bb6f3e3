"""Feature trackers: detector + descriptor + matcher bundles and their
presets (port of ``pyslam_tpu/features/tracker.py``).

Every preset that needs no learned weights runs: ORB2 / ORB2_BF / ORB /
FAST_ORB (FAST + rBRIEF), BRISK / ORB2_FREAK / ORB2_BEBLID (the ORB2
detector re-described with 512-bit patterns), SURF, KAZE, AKAZE, SIFT and
ROOT_SIFT (cv2 on the host), and the Lucas-Kanade trackers LK_FAST and
LK_SHI_TOMASI (``LkFeatureTracker.track_lk``).  Of the learned presets,
SUPERPOINT and LIGHTGLUE run with the JAX package's bundled weights; the
learned local features (XFeat, DISK, ALIKED, R2D2, D2-Net, Key.Net,
LF-Net, DELF, the patch descriptors HardNet / SOSNet / L2Net / TFeat /
GeoDesc / LogPolar over ORB2 or Shi-Tomasi keypoints, ContextDesc over
SIFT's) and LightGlue on their 64- or 128-d descriptors run with seeded
random weights (``trained = False``) until official checkpoints are
given (``extra["checkpoint"]``, ``"descriptor_checkpoint"``,
``"matcher_checkpoint"``).  The dense two-view matchers run with seeded
random weights too: LOFTR (``LoftrFeatureTracker``, detector-free:
``track_pair`` only, as the reference) and MAST3R
(``Mast3rFeatureTracker``: per-image keypoints from the two-view network
on (img, img), so the preset runs through ``Slam.track()``, and
``track_pair``).
"""

from __future__ import annotations

import enum
import importlib
from dataclasses import dataclass, field

import numpy as np
import torch

from pyslam_tpu_torch.features.binary_descriptors import DescribedExtractor
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
# the learned local features: the weights the JAX package bundles
# (SUPERPOINT, LIGHTGLUE) or seeded random ones
LEARNED_PRESETS = ("SUPERPOINT", "LIGHTGLUE", "XFEAT", "XFEAT_LIGHTGLUE", "DISK",
                   "LIGHTGLUE_DISK", "ALIKED", "LIGHTGLUE_ALIKED", "LIGHTGLUE_SIFT", "R2D2",
                   "D2NET", "KEYNET", "KEYNETAFFNETHARDNET", "ORB2_HARDNET", "ORB2_SOSNET",
                   "ORB2_L2NET", "ORB2_TFEAT", "SHI_TOMASI_HARDNET", "ORB2_GEODESC", "GEODESC",
                   "LOGPOLAR", "CONTEXTDESC", "LFNET", "DELF")
# the dense two-view matchers (seeded random weights)
DENSE_PRESETS = ("LOFTR", "MAST3R")
# every preset of the JAX package
PORTED_PRESETS = WEIGHT_FREE_PRESETS + LEARNED_PRESETS + DENSE_PRESETS

# detector -> (module of pyslam_tpu_torch.models, extractor class)
_LEARNED_DETECTORS = {
    _D.SUPERPOINT: ("superpoint", "SuperPointExtractor"), _D.XFEAT: ("xfeat", "XFeatExtractor"),
    _D.DISK: ("disk", "DiskExtractor"), _D.ALIKED: ("aliked", "AlikedExtractor"),
    _D.R2D2: ("r2d2", "R2D2Extractor"), _D.D2NET: ("d2net", "D2NetExtractor"),
    _D.LFNET: ("lfnet", "LFNetExtractor"), _D.DELF: ("delf", "DELFExtractor")}
_KEYNET_DESCRIPTORS = ("HARDNET", "SOSNET", "L2NET", "TFEAT")


class _StageDescribedExtractor(DescribedExtractor):
    """Detector + a learned descriptor stage over its keypoints: a patch
    network over their oriented 32x32 patches, or ContextDesc (one batched
    gather and one forward a frame)."""

    def __init__(self, base, descriptor):
        super().__init__(base)
        self.descriptor = descriptor

    def _describe(self, img: torch.Tensor, fd: FeatureData) -> FeatureData:
        return fd._replace(desc=self.descriptor.compute(img, fd.xy, fd.size, fd.angle))


def _make_extractor(config: FeatureTrackerConfig, device: torch.device):
    """The detector's extractor and the norm of its own descriptor."""
    det = config.detector_type
    checkpoint = config.extra.get("checkpoint")
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
    if det in _LEARNED_DETECTORS:
        module, cls = _LEARNED_DETECTORS[det]
        extractor = getattr(importlib.import_module(f"pyslam_tpu_torch.models.{module}"), cls)
        return (extractor(num_features=config.num_features, checkpoint=checkpoint,
                          device=device), NormType.L2)
    if det == _D.KEYNET:
        from pyslam_tpu_torch.models.keynet import KeyNetExtractor

        desc = config.descriptor_type.name
        return (KeyNetExtractor(num_features=config.num_features, checkpoint=checkpoint,
                                descriptor=desc if desc in _KEYNET_DESCRIPTORS else "HARDNET",
                                device=device), NormType.L2)
    raise ValueError(f"feature tracker preset {config.name}: detector {det.name} not supported")


class FeatureTracker:
    """Detector + descriptor + matcher bundle on ``device`` (the card
    unless the caller asks for another)."""

    def __init__(self, config: FeatureTrackerConfig, *, device: torch.device | str = "cuda"):
        desc = config.descriptor_type
        self.config = config
        self.device = torch.device(device)
        self.num_features = config.num_features
        self.num_levels = config.num_levels
        self.scale_factor = config.scale_factor
        self.extractor, self.norm = _make_extractor(config, self.device)
        extra = config.extra
        stage_ckpt = extra.get("descriptor_checkpoint")
        if desc in PATCH_DESCRIPTOR_TYPES and config.detector_type != _D.KEYNET:
            # (Key.Net computes its patch descriptors itself)
            from pyslam_tpu_torch.models.patch_descriptors import PatchDescriptorExtractor

            self.extractor = _StageDescribedExtractor(self.extractor, PatchDescriptorExtractor(
                desc.name, checkpoint=stage_ckpt, device=self.device))
            self.norm = NormType.L2
        elif desc == _S.CONTEXTDESC:
            from pyslam_tpu_torch.models.contextdesc import ContextDescExtractor

            self.extractor = _StageDescribedExtractor(self.extractor, ContextDescExtractor(
                checkpoint=stage_ckpt, device=self.device))
            self.norm = NormType.L2
        elif desc in (_S.BRISK, _S.FREAK, _S.BEBLID):
            from pyslam_tpu_torch.features.binary_descriptors import BinaryDescribedExtractor

            self.extractor = BinaryDescribedExtractor(self.extractor, desc.name)
            self.norm = NormType.HAMMING
        info = FEATURE_INFO.get(desc)
        if config.tracker_type == _T.LIGHTGLUE:
            self.matcher: FeatureMatcher = feature_matcher_factory(
                norm=self.norm, matcher_type=FeatureMatcherTypes.LIGHTGLUE,
                input_dim=int(extra.get("desc_dim", 256)),
                checkpoint=extra.get("matcher_checkpoint"), device=self.device)
        else:
            mtype = (FeatureMatcherTypes.NN if config.tracker_type == _T.DES_NN
                     else FeatureMatcherTypes.BF)
            self.matcher = feature_matcher_factory(
                norm=self.norm, matcher_type=mtype,
                max_distance=info.max_distance if info else None, ratio_test=config.ratio_test)
        self.scale_factors = self.extractor.scale_factors
        self.sigma2 = self.extractor.sigma2
        self.inv_sigma2 = 1.0 / self.sigma2

    @property
    def trained(self) -> bool:
        """Whether every learned part (detector, descriptor stage, matcher
        network) holds trained weights; True for a weight-free preset."""
        ex = self.extractor
        parts = (ex, getattr(ex, "base", None), getattr(ex, "descriptor", None),
                 getattr(self.matcher, "glue", None))
        return all(p.trained for p in parts if hasattr(p, "trained"))

    def detectAndCompute(self, img) -> FeatureData:
        """One (H, W) image -> FeatureData on ``device``."""
        return self.extractor(img)

    def match(self, f1: FeatureData, f2: FeatureData, ratio: float | None = None):
        """Match two FeatureData with the preset's matcher (the network of
        a matcher that has ``match_features``); returns (idx1, idx2) host
        arrays."""
        if hasattr(self.matcher, "match_features"):
            idx2, _ = self.matcher.match_features(f1, f2)
        else:
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


class Mast3rFeatureTracker(FeatureTracker):
    """MASt3R dense tracker: keypoints are the most descriptor-confident
    pixels of the two-view network run on (img, img)
    (``models.mast3r.Mast3rExtractor``), matched by brute-force L2 with the
    preset's ratio and ``FEATURE_INFO[MAST3R]``'s distance;
    ``track_pair`` is the joint two-view reciprocal matching."""

    def __init__(self, config: FeatureTrackerConfig, *, device: torch.device | str = "cuda"):
        from pyslam_tpu_torch.models.mast3r import Mast3rExtractor, Mast3rModel

        self.config = config
        self.device = torch.device(device)
        self.num_features = config.num_features
        self.num_levels = config.num_levels
        self.scale_factor = config.scale_factor
        self.model = Mast3rModel(checkpoint=config.extra.get("checkpoint"), device=self.device)
        self.extractor = Mast3rExtractor(self.model, config.num_features)
        self.norm = NormType.L2
        self.matcher = feature_matcher_factory(
            norm=NormType.L2, matcher_type=FeatureMatcherTypes.BF,
            max_distance=FEATURE_INFO[_S.MAST3R].max_distance, ratio_test=config.ratio_test)
        self.scale_factors = self.extractor.scale_factors
        self.sigma2 = self.extractor.sigma2
        self.inv_sigma2 = self.extractor.inv_sigma2

    def track_pair(self, img1, img2):
        """Joint two-view dense matching -> (xy1, xy2, scores) host arrays,
        each in its own image's input pixels."""
        xy1, xy2, s = self.model.match_pair(img1, img2)
        h1, w1 = np.asarray(img1).shape[:2]
        h2, w2 = np.asarray(img2).shape[:2]
        Hn, Wn = self.model.cfg.img_hw
        xy1 = xy1 * np.array([w1 / Wn, h1 / Hn], np.float32)
        xy2 = xy2 * np.array([w2 / Wn, h2 / Hn], np.float32)
        return xy1, xy2, s


class LoftrFeatureTracker:
    """LoFTR dense tracker: no per-image descriptors; correspondences come
    from joint two-view inference (``track_pair``)."""

    def __init__(self, config: FeatureTrackerConfig, *, device: torch.device | str = "cuda"):
        from pyslam_tpu_torch.models.loftr import LoFTRConfig, LoFTRMatcher

        self.config = config
        self.device = torch.device(device)
        self.num_features = config.num_features
        cfg = LoFTRConfig(max_matches=config.num_features,
                          img_hw=config.extra.get("img_hw", (480, 640)))
        self.matcher = LoFTRMatcher(cfg, checkpoint=config.extra.get("checkpoint"),
                                    device=self.device)
        self.norm = NormType.L2
        self.scale_factors = np.array([1.0], np.float32)
        self.sigma2 = np.array([1.0], np.float32)
        self.inv_sigma2 = 1.0 / self.sigma2

    @property
    def trained(self) -> bool:
        return self.matcher.trained

    def track_pair(self, img1, img2):
        return self.matcher.match_pair(img1, img2)

    def detectAndCompute(self, img):
        raise NotImplementedError(
            "LoFTR is detector-free; use track_pair(img1, img2) (the reference "
            "LoftrFeatureTracker has the same restriction)")


def feature_tracker_factory(config: FeatureTrackerConfig | str = "ORB2", *,
                            device: torch.device | str = "cuda"):
    if isinstance(config, str):
        config = FeatureTrackerConfigs.get(config)
    if config.tracker_type == _T.LK:
        return LkFeatureTracker(config, device=device)
    if config.tracker_type == _T.MAST3R:
        return Mast3rFeatureTracker(config, device=device)
    if config.tracker_type == _T.LOFTR:
        return LoftrFeatureTracker(config, device=device)
    return FeatureTracker(config, device=device)
