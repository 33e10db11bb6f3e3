"""Feature tracker: extractor bundle and its configuration (port of
``pyslam_tpu/features/tracker.py:43``, ``:380``, ``:685``).

Only the ORB2 preset is ported: the ORB2 extractor and its brute-force
Hamming matcher (ratio test, one-to-one cross-check; ``match``).  The other
presets (learned and classical extractors, LK, dense matchers) and the rest
of ``features/matcher.py`` come with later slices and are rejected here.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from pyslam_tpu_torch.features.orb2 import FeatureData, ORB2Extractor
from pyslam_tpu_torch.features.types import (
    FEATURE_INFO,
    FeatureDescriptorTypes,
    FeatureDetectorTypes,
    NormType,
)
from pyslam_tpu_torch.ops import hamming, matching


class FeatureTrackerTypes(enum.Enum):
    DES_BF = 0    # descriptor matching, brute force


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


class FeatureTrackerConfigs:
    ORB2 = FeatureTrackerConfig(name="ORB2")

    @staticmethod
    def get(name: str) -> FeatureTrackerConfig:
        if name != "ORB2":
            raise ValueError(f"feature tracker preset not ported yet: {name}")
        return FeatureTrackerConfigs.ORB2


class FeatureTracker:
    """ORB2 extractor on ``device`` with its level scales and variances."""

    def __init__(self, config: FeatureTrackerConfig, *, device: torch.device | str = "cuda"):
        if (config.detector_type != FeatureDetectorTypes.ORB2
                or config.descriptor_type != FeatureDescriptorTypes.ORB2
                or config.tracker_type != FeatureTrackerTypes.DES_BF):
            raise ValueError(f"feature tracker not ported yet: {config.name}")
        self.config = config
        self.device = torch.device(device)
        self.num_features = config.num_features
        self.num_levels = config.num_levels
        self.scale_factor = config.scale_factor
        self.extractor = ORB2Extractor(num_features=config.num_features,
                                       num_levels=config.num_levels,
                                       scale_factor=config.scale_factor,
                                       device=self.device)
        self.norm = NormType.HAMMING
        # the brute-force matcher's gates (reference FeatureMatcher with the
        # descriptor's acceptance distance and the preset's ratio)
        self.max_distance = FEATURE_INFO[config.descriptor_type].max_distance
        self.ratio_test = config.ratio_test
        self.scale_factors = self.extractor.scale_factors
        self.sigma2 = self.extractor.sigma2
        self.inv_sigma2 = 1.0 / self.sigma2

    def detectAndCompute(self, img) -> FeatureData:
        """One (H, W) image -> FeatureData on ``device``."""
        return self.extractor(img)

    def match(self, f1: FeatureData, f2: FeatureData, ratio: float | None = None):
        """Brute-force Hamming match of two FeatureData with the ratio test
        and the one-to-one cross-check; returns (idx1, idx2) host arrays."""
        idx2, _ = matching.match_ratio_test(
            hamming.hamming_distance_matrix(f1.desc, f2.desc), self.max_distance,
            ratio=ratio if ratio is not None else self.ratio_test, valid_a=f1.valid,
            valid_b=f2.valid, cross_check=True)
        idx2 = idx2.cpu().numpy()
        idx1 = np.nonzero(idx2 >= 0)[0]
        return idx1, idx2[idx1]


def feature_tracker_factory(config: FeatureTrackerConfig | str = "ORB2", *,
                            device: torch.device | str = "cuda") -> FeatureTracker:
    if isinstance(config, str):
        config = FeatureTrackerConfigs.get(config)
    return FeatureTracker(config, device=device)
