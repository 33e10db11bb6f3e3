"""Feature/descriptor type registry (reference: pySLAM
``pyslam/local_features/feature_types.py:39-217``): enums of detector and
descriptor types plus per-descriptor norm and match-acceptance distances.

Copied from ``pyslam_tpu/features/types.py`` (plain enums and tables).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class FeatureDetectorTypes(enum.Enum):
    NONE = 0
    ORB2 = 1          # our FAST+grid-NMS TPU pipeline (reference default)
    FAST = 2
    SHI_TOMASI = 3
    SUPERPOINT = 4
    XFEAT = 5
    DISK = 6
    ALIKED = 7
    SIFT = 8          # host cv2 detector (reference wraps cv2 the same way)
    ROOT_SIFT = 9
    R2D2 = 10
    MAST3R = 11
    D2NET = 12
    KEYNET = 13
    LFNET = 14
    DELF = 15
    CONTEXTDESC = 16  # SIFT keypoints re-described (reference wrapper)
    SURF = 17         # TPU-native box-filter Hessian (features/surf.py)
    KAZE = 18         # nonlinear diffusion scale space (features/akaze.py)
    AKAZE = 19


class FeatureDescriptorTypes(enum.Enum):
    NONE = 0
    ORB2 = 1          # 256-bit steered BRIEF
    SUPERPOINT = 2
    XFEAT = 3
    DISK = 4
    ALIKED = 5
    # patch-descriptor networks over any detector's oriented keypoints
    HARDNET = 6
    SOSNET = 7
    L2NET = 8
    TFEAT = 9
    SIFT = 10
    ROOT_SIFT = 11
    R2D2 = 12
    MAST3R = 13
    D2NET = 14
    GEODESC = 15
    LOGPOLAR = 16
    LFNET = 17
    DELF = 18
    CONTEXTDESC = 19
    # TPU-native classical binary patterns (features/binary_descriptors.py)
    BRISK = 20
    FREAK = 21
    BEBLID = 22
    SURF = 23
    KAZE = 24         # 64-float on diffused gradients
    AKAZE = 25        # M-LDB 486-bit


class NormType(enum.Enum):
    HAMMING = 0
    L2 = 1
    COSINE = 2


@dataclass(frozen=True)
class FeatureInfo:
    norm: NormType
    max_distance: float  # acceptance gate (reference FeatureInfo tables)


FEATURE_INFO = {
    FeatureDescriptorTypes.ORB2: FeatureInfo(NormType.HAMMING, 100.0),
    FeatureDescriptorTypes.SUPERPOINT: FeatureInfo(NormType.L2, 2.878),
    FeatureDescriptorTypes.XFEAT: FeatureInfo(NormType.L2, 1.2),
    FeatureDescriptorTypes.DISK: FeatureInfo(NormType.L2, 2.0),
    FeatureDescriptorTypes.ALIKED: FeatureInfo(NormType.L2, 1.2),
    # reference distances: pySLAM feature_types.py:203-218 (HARDNET 1.8,
    # SOSNET 2, L2NET 2.9, TFEAT 11)
    FeatureDescriptorTypes.HARDNET: FeatureInfo(NormType.L2, 1.8),
    FeatureDescriptorTypes.SOSNET: FeatureInfo(NormType.L2, 2.0),
    FeatureDescriptorTypes.L2NET: FeatureInfo(NormType.L2, 2.9),
    FeatureDescriptorTypes.TFEAT: FeatureInfo(NormType.L2, 11.0),
    # reference: SIFT 450, ROOT_SIFT 0.9 (feature_types.py:155-160)
    FeatureDescriptorTypes.SIFT: FeatureInfo(NormType.L2, 450.0),
    FeatureDescriptorTypes.ROOT_SIFT: FeatureInfo(NormType.L2, 0.9),
    FeatureDescriptorTypes.R2D2: FeatureInfo(NormType.L2, 1.4),
    FeatureDescriptorTypes.MAST3R: FeatureInfo(NormType.L2, 2.0),
    FeatureDescriptorTypes.D2NET: FeatureInfo(NormType.L2, 2.8),
    FeatureDescriptorTypes.GEODESC: FeatureInfo(NormType.L2, 1.8),
    FeatureDescriptorTypes.LOGPOLAR: FeatureInfo(NormType.L2, 1.8),
    FeatureDescriptorTypes.LFNET: FeatureInfo(NormType.L2, 2.0),
    FeatureDescriptorTypes.DELF: FeatureInfo(NormType.L2, 1.5),
    FeatureDescriptorTypes.CONTEXTDESC: FeatureInfo(NormType.L2, 1.8),
    # 512-bit patterns: gates scaled from ORB's 100/256 acceptance ratio
    FeatureDescriptorTypes.BRISK: FeatureInfo(NormType.HAMMING, 200.0),
    FeatureDescriptorTypes.FREAK: FeatureInfo(NormType.HAMMING, 200.0),
    FeatureDescriptorTypes.BEBLID: FeatureInfo(NormType.HAMMING, 200.0),
    FeatureDescriptorTypes.SURF: FeatureInfo(NormType.L2, 0.3),
    FeatureDescriptorTypes.KAZE: FeatureInfo(NormType.L2, 0.3),
    FeatureDescriptorTypes.AKAZE: FeatureInfo(NormType.HAMMING, 190.0),
}

# descriptor types computed by a patch network over the detector's keypoints
PATCH_DESCRIPTOR_TYPES = (
    FeatureDescriptorTypes.HARDNET,
    FeatureDescriptorTypes.SOSNET,
    FeatureDescriptorTypes.L2NET,
    FeatureDescriptorTypes.TFEAT,
    FeatureDescriptorTypes.GEODESC,
    FeatureDescriptorTypes.LOGPOLAR,
)
