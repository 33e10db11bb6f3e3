"""Map bootstrap for stereo streams (port of the stereo branch of
``pyslam_tpu/slam/initializer.py``): the first frame with enough
depth-valid keypoints becomes the first keyframe, and its depths become map
points.  The monocular (essential matrix) and RGBD branches are not ported
yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.slam.frame import Frame, KeyFrame
from pyslam_tpu_torch.slam.map import Map


@dataclass
class InitializerOutput:
    success: bool
    kf_ref: KeyFrame | None = None
    kf_cur: KeyFrame | None = None
    pids: np.ndarray | None = None


class Initializer:
    def __init__(self, sensor_type: SensorType, num_features: int = 2000):
        if sensor_type != SensorType.STEREO:
            raise NotImplementedError(f"{sensor_type.name} initialisation is not ported yet")
        self.sensor_type = sensor_type
        # the reference's absolute thresholds assume 2000 features: scale them
        s = num_features / 2000.0
        self.min_features = max(20, int(Parameters.kInitializerNumMinFeaturesStereo // 4 * s))
        self.num_failures = 0

    def reset(self):
        self.num_failures = 0

    def initialize(self, f: Frame, slam_map: Map, tracker=None) -> InitializerOutput:
        good = (f.depths > 0) & f.valid
        if good.sum() < self.min_features:
            return InitializerOutput(False)
        kf = KeyFrame(f)
        slam_map.add_keyframe(kf)
        pts_w, idxs = f.unproject_keypoints(np.nonzero(good)[0])
        pids = slam_map.add_points_for_keyframe(kf, idxs, pts_w)
        slam_map.update_connections(kf)
        return InitializerOutput(True, kf_ref=kf, kf_cur=kf, pids=pids)
