"""YAML configuration system (host copy of ``pyslam_tpu/config.py``).

Reference: pySLAM ``pyslam/config.py:49-556`` (``Config``): a top-level
``config.yaml`` selecting the dataset + per-dataset blocks, per-dataset
ORB-SLAM-style ``settings/*.yaml`` camera files, and the GLOBAL_PARAMETERS
override hook into the static Parameters registry
(reference ``config.py:219``).
"""

from __future__ import annotations

import os

import yaml

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.slam.camera import PinholeCamera


class Config:
    def __init__(self, config_path: str = "config.yaml"):
        self.config_path = config_path
        self.root = os.path.dirname(os.path.abspath(config_path))
        with open(config_path) as f:
            self.cfg = yaml.safe_load(f) or {}

        # GLOBAL_PARAMETERS hook: override static Parameters flags from yaml
        overrides = self.cfg.get("GLOBAL_PARAMETERS", {})
        if overrides:
            Parameters.set_from_dict(overrides)

        ds_name = self.cfg.get("DATASET", {}).get("type", "synthetic")
        self.dataset_settings = dict(self.cfg.get(ds_name.upper(), {}))
        self.dataset_settings.setdefault("type", ds_name)

        self.system_state_settings = self.cfg.get("SYSTEM_STATE", {})
        self.trajectory_settings = self.cfg.get("SAVE_TRAJECTORY", {})

        self._camera = None
        self._camera_settings = None
        settings_path = self.dataset_settings.get("settings")
        if settings_path:
            if not os.path.isabs(settings_path):
                settings_path = os.path.join(self.root, settings_path)
            self._camera_settings = self._load_camera_settings(settings_path)

    # ---------------------------------------------------------------- camera
    @staticmethod
    def _load_camera_settings(path: str) -> dict:
        """ORB-SLAM-format settings yaml (``Camera.fx`` etc., possibly with a
        ``%YAML:1.0`` header that pyyaml rejects)."""
        with open(path) as f:
            text = f.read()
        if text.startswith("%YAML"):
            text = "\n".join(
                line for line in text.splitlines() if not line.startswith("%")
            )
        text = text.replace("!!opencv-matrix", "")
        return yaml.safe_load(text) or {}

    @property
    def camera_settings(self) -> dict | None:
        return self._camera_settings

    @property
    def camera(self) -> PinholeCamera | None:
        if self._camera is not None:
            return self._camera
        s = self._camera_settings
        if s is None:
            return None
        D = [
            s.get("Camera.k1", 0.0), s.get("Camera.k2", 0.0),
            s.get("Camera.p1", 0.0), s.get("Camera.p2", 0.0),
            s.get("Camera.k3", 0.0),
        ]
        bf = s.get("Camera.bf", 0.0)
        th_depth = s.get("ThDepth", 40.0)
        fx = s["Camera.fx"]
        self._camera = PinholeCamera(
            width=s.get("Camera.width", s.get("Camera.cols", 640)),
            height=s.get("Camera.height", s.get("Camera.rows", 480)),
            fx=fx,
            fy=s["Camera.fy"],
            cx=s["Camera.cx"],
            cy=s["Camera.cy"],
            D=D,
            fps=s.get("Camera.fps", 30.0),
            bf=bf,
            depth_factor=s.get("DepthMapFactor", 1.0),
            depth_threshold=(bf * th_depth / fx) if bf else None,
        )
        return self._camera

    @property
    def num_features(self) -> int:
        s = self._camera_settings or {}
        return int(s.get("ORBextractor.nFeatures", Parameters.kNumFeatures))

    # ------------------------------------------------------------ subconfigs
    @property
    def feature_tracker_config_name(self) -> str:
        return self.dataset_settings.get("FeatureTrackerConfig.name", "ORB2")

    @property
    def loop_detection_config_name(self) -> str | None:
        return self.dataset_settings.get("LoopDetectionConfig.name", "DBOW3")

    @property
    def semantic_mapping_config_name(self) -> str | None:
        return self.dataset_settings.get("SemanticMappingConfig.name")

    @property
    def groundtruth_settings(self) -> dict:
        gt = dict(self.cfg.get("GROUNDTRUTH", {}))
        ds = self.dataset_settings
        if not gt and ds.get("groundtruth_file"):
            path = ds["groundtruth_file"]
            if not os.path.isabs(path):
                path = os.path.join(self.root, path)
            gt = {"type": ds.get("groundtruth_type", "kitti"), "path": path}
        return gt

    @property
    def sensor_type(self) -> str:
        return self.dataset_settings.get("sensor_type", "mono")
