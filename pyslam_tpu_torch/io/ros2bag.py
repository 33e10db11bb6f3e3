"""Pure-Python ROS2 bag (sqlite3) reading + CDR image decoding (port of
``pyslam_tpu/io/ros2bag.py``: the same stdlib code).

The reference's ROS2 stack (pySLAM ``pyslam/io/ros2bag_dataset.py`` +
native ``thirdparty/ros2_pybindings`` ``ros2_bag_sync_reader.cpp``) needs a
ROS installation; a rosbag2 SQLite file is just two tables (``topics``,
``messages``) and sensor_msgs/msg/Image payloads are plain CDR, both
parsed here in stdlib Python.

Includes a writer (used by tests and for trajectory export symmetry) and a
timestamp-synchronized multi-topic reader equivalent to the reference's
ApproximateTimeSynchronizer-based C++ sync reader.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from dataclasses import dataclass

import numpy as np

from pyslam_tpu_torch.io.dataset import DatasetBase
from pyslam_tpu_torch.io.dataset_types import DatasetEnvironmentType, SensorType


# --------------------------------------------------------------- CDR codec
class _CdrReader:
    """Little-endian XCDR1 primitive reader (alignment measured from the end
    of the 4-byte encapsulation header)."""

    def __init__(self, buf: bytes):
        assert buf[:2] == b"\x00\x01", "only CDR_LE encapsulation supported"
        self.buf = buf
        self.off = 4

    def _align(self, n):
        pad = (-(self.off - 4)) % n
        self.off += pad

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self):
        self._align(4)
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def i32(self):
        self._align(4)
        v = struct.unpack_from("<i", self.buf, self.off)[0]
        self.off += 4
        return v

    def string(self):
        n = self.u32()  # length INCLUDING the null terminator
        s = self.buf[self.off : self.off + n - 1].decode("utf-8", "replace")
        self.off += n
        return s

    def bytes_seq(self):
        n = self.u32()
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b


class _CdrWriter:
    def __init__(self):
        self.parts = [b"\x00\x01\x00\x00"]
        self.off = 4

    def _align(self, n):
        pad = (-(self.off - 4)) % n
        if pad:
            self.parts.append(b"\x00" * pad)
            self.off += pad

    def u8(self, v):
        self.parts.append(struct.pack("<B", v))
        self.off += 1

    def u32(self, v):
        self._align(4)
        self.parts.append(struct.pack("<I", v))
        self.off += 4

    def i32(self, v):
        self._align(4)
        self.parts.append(struct.pack("<i", v))
        self.off += 4

    def string(self, s: str):
        b = s.encode("utf-8") + b"\x00"
        self.u32(len(b))
        self.parts.append(b)
        self.off += len(b)

    def bytes_seq(self, b: bytes):
        self.u32(len(b))
        self.parts.append(bytes(b))
        self.off += len(b)

    def getvalue(self):
        return b"".join(self.parts)


@dataclass
class RosImage:
    stamp: float           # seconds
    frame_id: str
    height: int
    width: int
    encoding: str          # mono8 / rgb8 / bgr8 / 16UC1 / 32FC1
    data: bytes
    step: int

    def to_array(self) -> np.ndarray:
        if self.encoding in ("mono8", "8UC1"):
            a = np.frombuffer(self.data, np.uint8).reshape(self.height, self.step)
            return a[:, : self.width].astype(np.float32)
        if self.encoding in ("rgb8", "bgr8"):
            a = np.frombuffer(self.data, np.uint8).reshape(self.height, self.step // 1)
            a = a[:, : self.width * 3].reshape(self.height, self.width, 3)
            if self.encoding == "bgr8":
                a = a[..., ::-1]
            return (
                0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
            ).astype(np.float32)
        if self.encoding in ("16UC1", "mono16"):
            a = np.frombuffer(self.data, np.uint16).reshape(
                self.height, self.step // 2
            )
            return a[:, : self.width].astype(np.float32)
        if self.encoding == "32FC1":
            a = np.frombuffer(self.data, np.float32).reshape(
                self.height, self.step // 4
            )
            return np.ascontiguousarray(a[:, : self.width])
        raise ValueError(f"unsupported encoding {self.encoding}")


def decode_image(cdr: bytes) -> RosImage:
    """Decode a CDR-serialized sensor_msgs/msg/Image."""
    r = _CdrReader(cdr)
    sec = r.i32()
    nsec = r.u32()
    frame_id = r.string()
    height = r.u32()
    width = r.u32()
    encoding = r.string()
    _ = r.u8()  # is_bigendian
    step = r.u32()
    data = r.bytes_seq()
    return RosImage(sec + nsec * 1e-9, frame_id, height, width, encoding, data, step)


def encode_image(img: np.ndarray, stamp: float, encoding: str = "mono8",
                 frame_id: str = "camera") -> bytes:
    """CDR-serialize an image array as sensor_msgs/msg/Image."""
    w = _CdrWriter()
    sec = int(stamp)
    w.i32(sec)
    w.u32(int(round((stamp - sec) * 1e9)))
    w.string(frame_id)
    h, wd = img.shape[:2]
    w.u32(h)
    w.u32(wd)
    w.string(encoding)
    w.u8(0)
    if encoding in ("mono8", "8UC1"):
        data = np.ascontiguousarray(img, np.uint8).tobytes()
        step = wd
    elif encoding in ("16UC1", "mono16"):
        data = np.ascontiguousarray(img, np.uint16).tobytes()
        step = wd * 2
    elif encoding == "32FC1":
        data = np.ascontiguousarray(img, np.float32).tobytes()
        step = wd * 4
    elif encoding in ("rgb8", "bgr8"):
        data = np.ascontiguousarray(img, np.uint8).tobytes()
        step = wd * 3
    else:
        raise ValueError(encoding)
    w.u32(step)
    w.bytes_seq(data)
    return w.getvalue()


# ----------------------------------------------------------------- bag io
class Ros2BagReader:
    """Iterate (topic, t_ns, raw_cdr) from a rosbag2 .db3 file."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            db3 = sorted(
                p for p in os.listdir(path) if p.endswith(".db3")
            )
            if not db3:
                raise FileNotFoundError(f"no .db3 in {path}")
            path = os.path.join(path, db3[0])
        self.conn = sqlite3.connect(path)
        self.topics = {
            tid: (name, typ)
            for tid, name, typ in self.conn.execute(
                "SELECT id, name, type FROM topics"
            )
        }

    def topic_names(self):
        return [name for name, _ in self.topics.values()]

    def messages(self, topic: str | None = None):
        q = "SELECT topic_id, timestamp, data FROM messages ORDER BY timestamp"
        for tid, ts, data in self.conn.execute(q):
            name, _typ = self.topics[tid]
            if topic is None or name == topic:
                yield name, ts, data


class Ros2BagWriter:
    """Minimal rosbag2-compatible .db3 writer (tests + export symmetry)."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        c = self.conn.cursor()
        c.execute(
            "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT NULL,"
            " type TEXT NOT NULL, serialization_format TEXT NOT NULL,"
            " offered_qos_profiles TEXT NOT NULL)"
        )
        c.execute(
            "CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER"
            " NOT NULL, timestamp INTEGER NOT NULL, data BLOB NOT NULL)"
        )
        self._topic_ids = {}

    def add_topic(self, name: str, typ: str = "sensor_msgs/msg/Image"):
        tid = len(self._topic_ids) + 1
        self.conn.execute(
            "INSERT INTO topics VALUES (?,?,?,?,?)", (tid, name, typ, "cdr", "")
        )
        self._topic_ids[name] = tid
        return tid

    def write(self, topic: str, t_ns: int, data: bytes):
        self.conn.execute(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?,?,?)",
            (self._topic_ids[topic], int(t_ns), sqlite3.Binary(data)),
        )

    def close(self):
        self.conn.commit()
        self.conn.close()


def synchronize(streams: dict[str, list[tuple[int, bytes]]], tol_ns: int):
    """Greedy nearest-timestamp association across topics (equivalent of the
    reference's ros2_bag_sync_reader): yields dicts topic->(t_ns, payload)
    for every tuple whose pairwise time span fits in tol_ns."""
    names = list(streams)
    idx = {n: 0 for n in names}
    out = []
    base_name = names[0]
    for t0, p0 in streams[base_name]:
        group = {base_name: (t0, p0)}
        ok = True
        for n in names[1:]:
            s = streams[n]
            i = idx[n]
            while i + 1 < len(s) and abs(s[i + 1][0] - t0) <= abs(s[i][0] - t0):
                i += 1
            idx[n] = i
            if not s or abs(s[i][0] - t0) > tol_ns:
                ok = False
                break
            group[n] = s[i]
        if ok:
            out.append(group)
    return out


class Ros2BagDataset(DatasetBase):
    """Dataset over a rosbag2 .db3: image topic (+ optional right/depth
    topics), synchronized by nearest timestamp (reference
    ``ros2bag_dataset.py``)."""

    def __init__(self, path: str, topic: str, right_topic: str | None = None,
                 depth_topic: str | None = None, sensor_type=None,
                 sync_tol_ms: float = 20.0, depth_factor: float = 1000.0):
        reader = Ros2BagReader(path)
        streams = {topic: []}
        if right_topic:
            streams[right_topic] = []
        if depth_topic:
            streams[depth_topic] = []
        for name, ts, data in reader.messages():
            if name in streams:
                streams[name].append((ts, data))
        groups = synchronize(streams, int(sync_tol_ms * 1e6))
        self._frames = groups
        self._topic, self._right, self._depth = topic, right_topic, depth_topic
        self.num_frames = len(groups)
        self.depth_factor = depth_factor
        if sensor_type is None:
            sensor_type = (
                SensorType.RGBD if depth_topic
                else SensorType.STEREO if right_topic
                else SensorType.MONOCULAR
            )
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.INDOOR

    def _img(self, i, key):
        if i >= self.num_frames or key is None or key not in self._frames[i]:
            return None
        return decode_image(self._frames[i][key][1]).to_array()

    def getImage(self, i):
        return self._img(i, self._topic)

    def getImageRight(self, i):
        return self._img(i, self._right)

    def getDepth(self, i):
        d = self._img(i, self._depth)
        if d is None:
            return None
        return d / self.depth_factor

    def getTimestamp(self, i):
        return self._frames[i][self._topic][0] * 1e-9
