"""Dataset/sensor type enums shared across the I/O layer.

Mirrors the reference's surface (pySLAM ``pyslam/io/dataset_types.py`` /
``dataset_factory.py:78``): the same dataset-type names so configs carry over.

Host-only module, copied from ``pyslam_tpu/io/dataset_types.py`` (the machine with the
card has no JAX, so the port cannot import the reference).
"""

from __future__ import annotations

import enum


class SensorType(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class DatasetType(enum.Enum):
    KITTI = "kitti"
    TUM = "tum"
    EUROC = "euroc"
    ICL_NUIM = "icl_nuim"
    REPLICA = "replica"
    TARTANAIR = "tartanair"
    SCANNET = "scannet"
    SEVEN_SCENES = "seven_scenes"
    NEURAL_RGBD = "neural_rgbd"
    CLIO = "clio"
    ROVER = "rover"
    FOLDER = "folder"
    VIDEO = "video"
    LIVE = "live"
    ROS1BAG = "ros1bag"
    ROS2BAG = "ros2bag"
    MCAP = "mcap"
    SYNTHETIC = "synthetic"


class DatasetEnvironmentType(enum.Enum):
    INDOOR = 0
    OUTDOOR = 1
