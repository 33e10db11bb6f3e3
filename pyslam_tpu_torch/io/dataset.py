"""Dataset loaders: KITTI / TUM / EuRoC / ICL-NUIM / folder / video /
Replica / TartanAir / ScanNet / 7-Scenes / Neural-RGBD / live / Clio /
Rover (host copy of ``pyslam_tpu/io/dataset.py``).

Every loader has the iteration surface ``getImage(i)``,
``getImageRight(i)``, ``getDepth(i)``, ``getTimestamp(i)``,
``num_frames``, ``sensor_type``.  Images are decoded with PIL exactly as
the JAX package decodes them (the same arrays, byte for byte): float32
grayscale (H, W) in [0, 255], 16- and 32-bit grayscale kept as they are,
metric depth as the PNG's value over ``depth_factor`` in float32.  OpenCV
(live camera) and imageio (video) are imported only when such a loader is
built.  The synthetic stream lives in ``io/synthetic.py`` and is importable
from here too.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from pyslam_tpu_torch.io.dataset_types import DatasetEnvironmentType, SensorType


def _imread_gray(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("L", "I;16", "I"):
        img = img.convert("L")
    arr = np.asarray(img)
    return arr.astype(np.float32)


def _imread_color(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _imread_depth_png(path: str, depth_factor: float) -> np.ndarray:
    from PIL import Image

    arr = np.asarray(Image.open(path)).astype(np.float32)
    return arr / depth_factor


class DatasetBase:
    sensor_type: SensorType = SensorType.MONOCULAR
    environment_type: DatasetEnvironmentType = DatasetEnvironmentType.OUTDOOR
    num_frames: int = 0
    fps: float = 30.0
    depth_factor: float = 1.0

    def getImage(self, i: int) -> np.ndarray | None:
        raise NotImplementedError

    def getImageColor(self, i: int) -> np.ndarray | None:
        return None

    def getImageRight(self, i: int) -> np.ndarray | None:
        return None

    def getDepth(self, i: int) -> np.ndarray | None:
        return None

    def getTimestamp(self, i: int) -> float:
        return i / self.fps

    def isOk(self) -> bool:
        return True

    def __len__(self) -> int:
        return self.num_frames

    def __iter__(self):
        for i in range(self.num_frames):
            yield i, self.getImage(i), self.getImageRight(i), self.getDepth(i), self.getTimestamp(i)


class KittiDataset(DatasetBase):
    """KITTI odometry: ``sequences/NN/image_0`` (left) / ``image_1`` (right),
    ``times.txt`` (reference KittiDataset, pySLAM ``io/dataset.py``)."""

    def __init__(self, base_path: str, sequence: str, sensor_type=SensorType.STEREO):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.OUTDOOR
        seq_dir = os.path.join(base_path, "sequences", sequence)
        self.left = sorted(glob.glob(os.path.join(seq_dir, "image_0", "*.png")))
        self.right = sorted(glob.glob(os.path.join(seq_dir, "image_1", "*.png")))
        self.num_frames = len(self.left)
        times_file = os.path.join(seq_dir, "times.txt")
        if os.path.exists(times_file):
            self.timestamps = np.loadtxt(times_file)
        else:
            self.timestamps = np.arange(self.num_frames) / 10.0
        self.fps = 10.0

    def getImage(self, i):
        return _imread_gray(self.left[i]) if i < self.num_frames else None

    def getImageColor(self, i):
        return _imread_color(self.left[i]) if i < self.num_frames else None

    def getImageRight(self, i):
        if self.sensor_type == SensorType.STEREO and i < len(self.right):
            return _imread_gray(self.right[i])
        return None

    def getTimestamp(self, i):
        return float(self.timestamps[i])


class TumDataset(DatasetBase):
    """TUM RGBD: ``rgb.txt`` / ``depth.txt`` with timestamp filename pairs,
    associated by nearest timestamp (reference TumDataset + associate logic)."""

    def __init__(self, base_path: str, sequence: str, associations: str | None = None,
                 sensor_type=SensorType.RGBD):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.INDOOR
        self.depth_factor = 5000.0
        self.seq_dir = os.path.join(base_path, sequence)
        rgb_list = self._read_file_list(os.path.join(self.seq_dir, "rgb.txt"))
        depth_list = self._read_file_list(os.path.join(self.seq_dir, "depth.txt"))
        pairs = self._associate(rgb_list, depth_list, max_dt=0.08)
        self.rgb_files = [rgb_list[a] for a, b in pairs]
        self.depth_files = [depth_list[b] for a, b in pairs]
        self.timestamps = np.array([a for a, b in pairs])
        self.num_frames = len(pairs)
        self.fps = 30.0

    @staticmethod
    def _read_file_list(path: str) -> dict:
        out = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                out[float(parts[0])] = parts[1]
        return out

    @staticmethod
    def _associate(a: dict, b: dict, max_dt: float):
        """Greedy nearest-timestamp association (same algorithm as the TUM
        benchmark's associate.py used by the reference)."""
        pairs = []
        b_keys = sorted(b.keys())
        used = set()
        for ta in sorted(a.keys()):
            best, best_dt = None, max_dt
            import bisect

            i = bisect.bisect_left(b_keys, ta)
            for j in (i - 1, i, i + 1):
                if 0 <= j < len(b_keys) and b_keys[j] not in used:
                    dt = abs(b_keys[j] - ta)
                    if dt < best_dt:
                        best, best_dt = b_keys[j], dt
            if best is not None:
                used.add(best)
                pairs.append((ta, best))
        return pairs

    def getImage(self, i):
        return _imread_gray(os.path.join(self.seq_dir, self.rgb_files[i]))

    def getImageColor(self, i):
        return _imread_color(os.path.join(self.seq_dir, self.rgb_files[i]))

    def getDepth(self, i):
        return _imread_depth_png(
            os.path.join(self.seq_dir, self.depth_files[i]), self.depth_factor
        )

    def getTimestamp(self, i):
        return float(self.timestamps[i])


class EurocDataset(DatasetBase):
    """EuRoC MAV: ``mav0/cam0/data`` + ``cam1/data``, timestamps from csv."""

    def __init__(self, base_path: str, sequence: str, sensor_type=SensorType.STEREO):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.INDOOR
        seq = os.path.join(base_path, sequence, "mav0")
        self.left = sorted(glob.glob(os.path.join(seq, "cam0", "data", "*.png")))
        self.right = sorted(glob.glob(os.path.join(seq, "cam1", "data", "*.png")))
        self.num_frames = len(self.left)
        self.timestamps = np.array(
            [float(os.path.splitext(os.path.basename(p))[0]) * 1e-9 for p in self.left]
        )
        self.fps = 20.0

    def getImage(self, i):
        return _imread_gray(self.left[i])

    def getImageRight(self, i):
        if self.sensor_type == SensorType.STEREO and i < len(self.right):
            return _imread_gray(self.right[i])
        return None

    def getTimestamp(self, i):
        return float(self.timestamps[i])


class IclNuimDataset(TumDataset):
    """ICL-NUIM in TUM-compatible layout (reference treats it the same)."""

    def __init__(self, base_path, sequence, **kw):
        super().__init__(base_path, sequence, **kw)
        self.depth_factor = 5000.0


class FolderDataset(DatasetBase):
    """Glob a folder of images (reference FolderDataset)."""

    def __init__(self, path: str, pattern: str = "*.png", fps: float = 30.0,
                 sensor_type=SensorType.MONOCULAR):
        self.sensor_type = sensor_type
        self.files = sorted(glob.glob(os.path.join(path, pattern)))
        self.num_frames = len(self.files)
        self.fps = fps

    def getImage(self, i):
        return _imread_gray(self.files[i]) if i < self.num_frames else None

    def getImageColor(self, i):
        return _imread_color(self.files[i]) if i < self.num_frames else None


class VideoDataset(DatasetBase):
    """Video file via imageio/ffmpeg when available (reference VideoDataset)."""

    def __init__(self, path: str, fps: float = 30.0, sensor_type=SensorType.MONOCULAR):
        self.sensor_type = sensor_type
        self.fps = fps
        try:
            import imageio.v3 as iio

            self._frames = iio.imread(path)  # (T,H,W,3)
            self.num_frames = len(self._frames)
        except Exception as e:  # pragma: no cover - environment dependent
            raise RuntimeError(f"video decoding unavailable: {e}")

    def getImage(self, i):
        f = self._frames[i]
        return (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]).astype(
            np.float32
        )


class ReplicaDataset(DatasetBase):
    """Replica (NICE-SLAM export layout): ``results/frameNNNNNN.jpg`` +
    ``results/depthNNNNNN.png`` (depth factor 6553.5), ``traj.txt`` GT poses
    (reference ReplicaDataset, pySLAM ``io/dataset.py``)."""

    def __init__(self, base_path: str, sequence: str = "",
                 sensor_type=SensorType.RGBD, depth_factor: float = 6553.5):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.INDOOR
        root = os.path.join(base_path, sequence) if sequence else base_path
        res = os.path.join(root, "results")
        self.rgb = sorted(
            glob.glob(os.path.join(res, "frame*.jpg"))
            + glob.glob(os.path.join(res, "frame*.png"))
        )
        self.depth = sorted(glob.glob(os.path.join(res, "depth*.png")))
        self.num_frames = len(self.rgb)
        self.depth_factor = depth_factor
        self.fps = 30.0

    def getImage(self, i):
        return _imread_gray(self.rgb[i]) if i < self.num_frames else None

    def getImageColor(self, i):
        return _imread_color(self.rgb[i]) if i < self.num_frames else None

    def getDepth(self, i):
        if self.sensor_type == SensorType.RGBD and i < len(self.depth):
            return _imread_depth_png(self.depth[i], self.depth_factor)
        return None


class TartanAirDataset(DatasetBase):
    """TartanAir: ``image_left/NNNNNN_left.png`` (+ ``image_right``),
    ``depth_left/NNNNNN_left_depth.npy`` (metric float32), ``pose_left.txt``
    (reference TartanAir handling in pySLAM's dataset factory)."""

    def __init__(self, base_path: str, sequence: str = "",
                 sensor_type=SensorType.RGBD):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.OUTDOOR
        root = os.path.join(base_path, sequence) if sequence else base_path
        self.left = sorted(glob.glob(os.path.join(root, "image_left", "*.png")))
        self.right = sorted(glob.glob(os.path.join(root, "image_right", "*.png")))
        self.depths = sorted(glob.glob(os.path.join(root, "depth_left", "*.npy")))
        self.num_frames = len(self.left)
        self.fps = 10.0

    def getImage(self, i):
        return _imread_gray(self.left[i]) if i < self.num_frames else None

    def getImageColor(self, i):
        return _imread_color(self.left[i]) if i < self.num_frames else None

    def getImageRight(self, i):
        if self.sensor_type == SensorType.STEREO and i < len(self.right):
            return _imread_gray(self.right[i])
        return None

    def getDepth(self, i):
        if self.sensor_type == SensorType.RGBD and i < len(self.depths):
            return np.load(self.depths[i]).astype(np.float32)
        return None


class ScanNetDataset(DatasetBase):
    """ScanNet (exported): ``color/N.jpg`` + ``depth/N.png`` in millimeters
    (factor 1000); frames indexed by integer filename."""

    def __init__(self, base_path: str, sequence: str = "",
                 sensor_type=SensorType.RGBD):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.INDOOR
        root = os.path.join(base_path, sequence) if sequence else base_path

        def by_index(paths):
            return sorted(
                paths, key=lambda p: int(os.path.splitext(os.path.basename(p))[0])
            )

        self.rgb = by_index(
            glob.glob(os.path.join(root, "color", "*.jpg"))
            + glob.glob(os.path.join(root, "color", "*.png"))
        )
        self.depth = by_index(glob.glob(os.path.join(root, "depth", "*.png")))
        self.num_frames = len(self.rgb)
        self.depth_factor = 1000.0
        self.fps = 30.0

    def getImage(self, i):
        return _imread_gray(self.rgb[i]) if i < self.num_frames else None

    def getImageColor(self, i):
        return _imread_color(self.rgb[i]) if i < self.num_frames else None

    def getDepth(self, i):
        if self.sensor_type == SensorType.RGBD and i < len(self.depth):
            return _imread_depth_png(self.depth[i], self.depth_factor)
        return None


class SevenScenesDataset(DatasetBase):
    """7-Scenes: ``seq-XX/frame-NNNNNN.color.png`` + ``.depth.png``
    (millimeters; 65535 = invalid -> 0)."""

    def __init__(self, base_path: str, sequence: str = "seq-01",
                 sensor_type=SensorType.RGBD):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.INDOOR
        root = os.path.join(base_path, sequence)
        self.rgb = sorted(glob.glob(os.path.join(root, "frame-*.color.png")))
        self.depth = sorted(glob.glob(os.path.join(root, "frame-*.depth.png")))
        self.num_frames = len(self.rgb)
        self.depth_factor = 1000.0
        self.fps = 30.0

    def getImage(self, i):
        return _imread_gray(self.rgb[i]) if i < self.num_frames else None

    def getImageColor(self, i):
        return _imread_color(self.rgb[i]) if i < self.num_frames else None

    def getDepth(self, i):
        if self.sensor_type == SensorType.RGBD and i < len(self.depth):
            d = _imread_depth_png(self.depth[i], self.depth_factor)
            return np.where(d >= 65.0, 0.0, d).astype(np.float32)
        return None


class NeuralRgbdDataset(DatasetBase):
    """Neural-RGBD: ``images/imgNNNN.png`` + ``depth/depthNNNN.png``
    (millimeters), optional ``poses.txt``."""

    def __init__(self, base_path: str, sequence: str = "",
                 sensor_type=SensorType.RGBD):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.INDOOR
        root = os.path.join(base_path, sequence) if sequence else base_path
        self.rgb = sorted(glob.glob(os.path.join(root, "images", "img*.png")))
        self.depth = sorted(glob.glob(os.path.join(root, "depth", "depth*.png")))
        self.num_frames = len(self.rgb)
        self.depth_factor = 1000.0
        self.fps = 30.0

    def getImage(self, i):
        return _imread_gray(self.rgb[i]) if i < self.num_frames else None

    def getImageColor(self, i):
        return _imread_color(self.rgb[i]) if i < self.num_frames else None

    def getDepth(self, i):
        if self.sensor_type == SensorType.RGBD and i < len(self.depth):
            return _imread_depth_png(self.depth[i], self.depth_factor)
        return None


class LiveDataset(DatasetBase):
    """Live camera via OpenCV (reference LiveDataset). Frames are pulled on
    demand; ``num_frames`` is a soft cap for the main loop."""

    def __init__(self, camera_id: int = 0, num_frames: int = 10 ** 9,
                 fps: float = 30.0, sensor_type=SensorType.MONOCULAR):
        import cv2

        self.sensor_type = sensor_type
        self.cap = cv2.VideoCapture(camera_id)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open camera {camera_id}")
        self.num_frames = num_frames
        self.fps = fps
        self._last = None

    def getImage(self, i):
        ok, frame = self.cap.read()
        if not ok:
            return None
        self._last = frame
        return (
            0.299 * frame[..., 2] + 0.587 * frame[..., 1] + 0.114 * frame[..., 0]
        ).astype(np.float32)

    def getImageColor(self, i):
        return self._last[..., ::-1] if self._last is not None else None

    def isOk(self):
        return self.cap.isOpened()


class ClioDataset(DatasetBase):
    """CLIO (MIT task-driven mapping): ``images/rgb_<id>.jpg`` +
    ``depth/depth_<id>.png``, frame ids from filenames, synthetic
    timestamps at the measured ~7.5 Hz playback rate (reference
    ``dataset.py ClioDataset``)."""

    def __init__(self, base_path: str, sequence: str = "",
                 sensor_type=SensorType.RGBD, fps: float = 7.5):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.INDOOR
        self.depth_factor = 1000.0
        base = os.path.join(base_path, sequence) if sequence else base_path
        self.images_dir = os.path.join(base, "images")
        self.depth_dir = os.path.join(base, "depth")

        def fid(path, prefix):
            return int(os.path.basename(path).replace(prefix, "")
                       .split(".")[0])

        self.rgb = sorted(glob.glob(os.path.join(self.images_dir, "rgb_*.jpg")),
                          key=lambda p: fid(p, "rgb_"))
        self.frame_ids = [fid(p, "rgb_") for p in self.rgb]
        if sensor_type == SensorType.RGBD and not os.path.isdir(self.depth_dir):
            self.sensor_type = SensorType.MONOCULAR
        self.num_frames = len(self.rgb)
        self.fps = fps
        self.Ts = 1.0 / fps

    def getImage(self, i):
        return _imread_gray(self.rgb[i]) if i < self.num_frames else None

    def getImageColor(self, i):
        return _imread_color(self.rgb[i]) if i < self.num_frames else None

    def getDepth(self, i):
        if self.sensor_type != SensorType.RGBD or i >= self.num_frames:
            return None
        path = os.path.join(self.depth_dir, f"depth_{self.frame_ids[i]}.png")
        if not os.path.isfile(path):
            return None
        return _imread_depth_png(path, self.depth_factor)

    def getTimestamp(self, i):
        return float(i * self.Ts)


class RoverDataset(DatasetBase):
    """ROVER (outdoor robot benchmark): per-camera directory with a
    TUM-style associations file ``<timestamp> <rgb path> [<ts> <depth
    path>]`` (reference ``dataset.py RoverDataset``)."""

    def __init__(self, base_path: str, sequence: str,
                 camera_name: str = "realsense_d435i",
                 associations: str = "associations.txt",
                 sensor_type=SensorType.RGBD):
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.OUTDOOR
        self.depth_factor = 1000.0
        self.base_dir = os.path.join(base_path, sequence, camera_name)
        self.rows = []
        with open(os.path.join(self.base_dir, associations)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                self.rows.append(line.split())
        self.num_frames = len(self.rows)
        self.fps = 30.0

    def getImage(self, i):
        if i >= self.num_frames:
            return None
        return _imread_gray(os.path.join(self.base_dir, self.rows[i][1]))

    def getImageColor(self, i):
        if i >= self.num_frames:
            return None
        return _imread_color(os.path.join(self.base_dir, self.rows[i][1]))

    def getDepth(self, i):
        if (self.sensor_type != SensorType.RGBD or i >= self.num_frames
                or len(self.rows[i]) < 4):
            return None
        return _imread_depth_png(
            os.path.join(self.base_dir, self.rows[i][3]), self.depth_factor)

    def getTimestamp(self, i):
        return float(self.rows[i][0])


def __getattr__(name):
    # the synthetic stream subclasses DatasetBase, so it is imported lazily
    if name in ("SyntheticDataset", "SyntheticWorld"):
        from pyslam_tpu_torch.io import synthetic

        return getattr(synthetic, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
