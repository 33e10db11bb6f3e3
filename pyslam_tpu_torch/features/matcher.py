"""Feature matchers over dense distance matrices (port of
``pyslam_tpu/features/matcher.py``).

A matcher is a small configuration object: the distance (Hamming for
binary bit-planes, L2 or cosine for float descriptors) and the filtering
mode (brute force with the ratio test and a one-to-one cross-check, or a
plain gated nearest neighbour).  The work is done by ``ops.hamming`` and
``ops.matching`` on the descriptors' device.  The attention matcher
(LightGlue) needs learned weights and waits for the learned-model slice.
"""

from __future__ import annotations

import enum

import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.features.types import NormType
from pyslam_tpu_torch.ops import hamming, matching


class FeatureMatcherTypes(enum.Enum):
    BF = 0         # brute force + ratio test + one-to-one (default)
    NN = 1         # plain nearest neighbour with gate
    XFEAT = 2      # learned matcher slot (MNN over float descs)
    LIGHTGLUE = 3  # learned matcher slot


class FeatureMatcher:
    def __init__(self, norm: NormType = NormType.HAMMING,
                 matcher_type: FeatureMatcherTypes = FeatureMatcherTypes.BF,
                 max_distance: float | None = None, ratio_test: float | None = None):
        self.norm = norm
        self.matcher_type = matcher_type
        self.max_distance = (max_distance if max_distance is not None
                             else Parameters.kMaxDescriptorDistance)
        self.ratio_test = ratio_test if ratio_test is not None else Parameters.kMatchRatioTest

    def distance_matrix(self, des1: torch.Tensor, des2: torch.Tensor) -> torch.Tensor:
        if self.norm == NormType.HAMMING:
            return hamming.hamming_distance_matrix(des1, des2)
        if self.norm == NormType.L2:
            return hamming.l2_distance_matrix(des1, des2)
        # cosine distance for normalised float descriptors
        return 1.0 - des1.to(torch.float32) @ des2.to(torch.float32).transpose(-1, -2)

    def match(self, des1, des2, valid1=None, valid2=None, ratio=None, mask=None):
        """(idx2 for each row of des1, -1 where unmatched; distances)."""
        d = self.distance_matrix(des1, des2)
        if self.matcher_type == FeatureMatcherTypes.NN:
            return matching.match_nn(d, self.max_distance, valid_a=valid1, valid_b=valid2,
                                     extra_mask=mask)
        return matching.match_ratio_test(
            d, self.max_distance, ratio=ratio if ratio is not None else self.ratio_test,
            valid_a=valid1, valid_b=valid2, cross_check=True, extra_mask=mask)


class LightGlueFeatureMatcher(FeatureMatcher):
    """The attention matcher: it runs a learned network, which the port
    brings with the learned-model slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "LightGlue needs learned weights: it comes with the learned-model slice "
            "(ROADMAP item 3, learned models with bundled weights)")


def feature_matcher_factory(norm: NormType = NormType.HAMMING,
                            matcher_type: FeatureMatcherTypes = FeatureMatcherTypes.BF,
                            **kw) -> FeatureMatcher:
    if matcher_type == FeatureMatcherTypes.LIGHTGLUE:
        kw.pop("max_distance", None)
        return LightGlueFeatureMatcher(norm=norm, **kw)
    return FeatureMatcher(norm=norm, matcher_type=matcher_type, **kw)
