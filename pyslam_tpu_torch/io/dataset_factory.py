"""Dataset factory dispatch (host copy of
``pyslam_tpu/io/dataset_factory.py``; reference: pySLAM
``io/dataset_factory.py:78``).  The ROS1 / ROS2 bag and MCAP readers are
not ported: those types raise ``NotImplementedError``."""

from __future__ import annotations

from pyslam_tpu_torch.io.dataset import (
    ClioDataset,
    DatasetBase,
    EurocDataset,
    FolderDataset,
    IclNuimDataset,
    KittiDataset,
    LiveDataset,
    NeuralRgbdDataset,
    ReplicaDataset,
    RoverDataset,
    ScanNetDataset,
    SevenScenesDataset,
    TartanAirDataset,
    TumDataset,
    VideoDataset,
)
from pyslam_tpu_torch.io.dataset_types import DatasetType, SensorType

BAG_READERS_ITEM = "ROADMAP.md item 4 (io/colmap_io.py, ros1bag.py, ros2bag.py and mcap_io.py)"


def dataset_factory(config) -> DatasetBase:
    """Build a dataset from a config object/dict with the reference's fields:
    ``type``, ``base_path``/``path``, ``name``/``sequence``, ``sensor_type``."""
    if isinstance(config, dict):
        d = config
    else:
        d = config.dataset_settings

    ds_type = d.get("type", "synthetic")
    if isinstance(ds_type, str):
        ds_type = DatasetType(ds_type.lower())
    sensor = d.get("sensor_type", "mono")
    if isinstance(sensor, str):
        sensor = {
            "mono": SensorType.MONOCULAR,
            "monocular": SensorType.MONOCULAR,
            "stereo": SensorType.STEREO,
            "rgbd": SensorType.RGBD,
        }[sensor.lower()]

    base = d.get("base_path", d.get("path", "."))
    name = d.get("name", d.get("sequence", ""))

    if ds_type == DatasetType.KITTI:
        return KittiDataset(base, name, sensor)
    if ds_type == DatasetType.TUM:
        return TumDataset(base, name, sensor_type=sensor)
    if ds_type == DatasetType.ICL_NUIM:
        return IclNuimDataset(base, name, sensor_type=sensor)
    if ds_type == DatasetType.EUROC:
        return EurocDataset(base, name, sensor)
    if ds_type == DatasetType.FOLDER:
        return FolderDataset(base, d.get("glob", "*.png"), d.get("fps", 30.0), sensor)
    if ds_type == DatasetType.VIDEO:
        return VideoDataset(base, d.get("fps", 30.0), sensor)
    if ds_type == DatasetType.REPLICA:
        return ReplicaDataset(base, name, sensor_type=sensor)
    if ds_type == DatasetType.TARTANAIR:
        return TartanAirDataset(base, name, sensor_type=sensor)
    if ds_type == DatasetType.SCANNET:
        return ScanNetDataset(base, name, sensor_type=sensor)
    if ds_type == DatasetType.CLIO:
        return ClioDataset(base, name, sensor_type=sensor, fps=float(d.get("fps", 7.5)))
    if ds_type == DatasetType.ROVER:
        return RoverDataset(
            base, name, camera_name=d.get("camera_name", "realsense_d435i"),
            associations=d.get("associations", "associations.txt"),
            sensor_type=sensor)
    if ds_type == DatasetType.SEVEN_SCENES:
        return SevenScenesDataset(base, name or "seq-01", sensor_type=sensor)
    if ds_type == DatasetType.NEURAL_RGBD:
        return NeuralRgbdDataset(base, name, sensor_type=sensor)
    if ds_type == DatasetType.LIVE:
        return LiveDataset(
            d.get("camera_id", 0), d.get("num_frames", 10 ** 9),
            d.get("fps", 30.0), sensor,
        )
    if ds_type in (DatasetType.ROS1BAG, DatasetType.ROS2BAG, DatasetType.MCAP):
        raise NotImplementedError(f"the {ds_type.name} reader is not ported yet: "
                                  f"{BAG_READERS_ITEM}")
    if ds_type == DatasetType.SYNTHETIC:
        from pyslam_tpu_torch.io.synthetic import SyntheticDataset

        return SyntheticDataset(
            num_frames=d.get("num_frames", 60),
            h=d.get("h", 240),
            w=d.get("w", 320),
            fx=d.get("fx", 200.0),
            baseline=d.get("baseline", 0.2),
            trajectory=d.get("trajectory", "arc"),
            sensor_type=sensor,
            world=d.get("world"),
            step=d.get("step", 0.25),
            period=d.get("period"),
        )
    raise ValueError(f"dataset type not supported yet: {ds_type}")
