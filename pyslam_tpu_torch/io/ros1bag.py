"""Pure-Python ROS1 bag (v2.0) reader + writer and dataset adapter.
(port of ``pyslam_tpu/io/ros1bag.py``: the same code).

Reference capability: pySLAM's ROS1 bag dataset
(``pyslam/io/ros1bag_dataset.py``, backed by the ``rosbag`` package).
This environment has no ROS, so the container format is implemented
directly (same spirit as our sqlite3+CDR ROS2 reader in io/ros2bag.py):

  * record grammar: ``header_len | header(fields: len,"name=",value) |
    data_len | data`` with op codes 0x03 bag-header, 0x05 chunk (none/bz2
    compression), 0x07 connection, 0x02 message-data, 0x04/0x06 indexes;
  * chunks are decompressed and their inner connection/message records
    parsed in place (no index needed — a linear scan, which also recovers
    unindexed/truncated bags);
  * message decoding for the SLAM-relevant types: ``sensor_msgs/Image``
    and ``sensor_msgs/CompressedImage`` (ROS1 little-endian field packing).

The writer emits uncompressed, unindexed-but-valid v2.0 bags (readable by
this reader and by ``rosbag`` tooling that tolerates reindexing) — enough
for round-trip tests and for exporting sequences.
"""

from __future__ import annotations

import bz2
import os
import struct
from dataclasses import dataclass


def _pack_fields(fields: dict[str, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _parse_fields(buf: bytes) -> dict[str, bytes]:
    fields = {}
    i = 0
    while i < len(buf):
        (n,) = struct.unpack_from("<I", buf, i)
        i += 4
        item = buf[i:i + n]
        i += n
        k, _, v = item.partition(b"=")
        fields[k.decode()] = v
    return fields


def _read_record(buf: bytes, i: int):
    (hl,) = struct.unpack_from("<I", buf, i)
    header = _parse_fields(buf[i + 4:i + 4 + hl])
    j = i + 4 + hl
    (dl,) = struct.unpack_from("<I", buf, j)
    data = buf[j + 4:j + 4 + dl]
    return header, data, j + 4 + dl


@dataclass
class Ros1Message:
    topic: str
    msgtype: str
    timestamp: float  # seconds
    raw: bytes


class Ros1BagReader:
    def __init__(self, path: str, topics: list[str] | None = None):
        self.path = path
        self.topics = set(topics) if topics else None
        self.connections: dict[int, dict] = {}
        self.messages: list[Ros1Message] = []
        self._parse()

    def _parse(self):
        with open(self.path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a ROS1 v2.0 bag: {magic!r}")
            buf = f.read()
        i = 0
        while i < len(buf):
            header, data, i = _read_record(buf, i)
            self._handle(header, data)
        self.messages.sort(key=lambda m: m.timestamp)

    def _handle(self, header: dict, data: bytes):
        op = header.get("op", b"\x00")[0]
        if op == 0x05:  # chunk
            comp = header.get("compression", b"none").decode()
            if comp == "bz2":
                data = bz2.decompress(data)
            elif comp != "none":
                return  # lz4 unsupported; skip chunk
            j = 0
            while j < len(data):
                h2, d2, j = _read_record(data, j)
                self._handle(h2, d2)
        elif op == 0x07:  # connection
            (conn,) = struct.unpack("<I", header["conn"])
            fields = _parse_fields(data)
            self.connections[conn] = {
                "topic": header.get("topic", b"").decode(),
                "type": fields.get("type", b"").decode(),
            }
        elif op == 0x02:  # message data
            (conn,) = struct.unpack("<I", header["conn"])
            secs, nsecs = struct.unpack("<II", header["time"])
            c = self.connections.get(conn, {})
            topic = c.get("topic", "")
            if self.topics is not None and topic not in self.topics:
                return
            self.messages.append(Ros1Message(
                topic, c.get("type", ""), secs + nsecs * 1e-9, data))

    def topics_summary(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for m in self.messages:
            out[m.topic] = out.get(m.topic, 0) + 1
        return out


# --------------------------------------------------- sensor_msgs decoding
def _read_string(buf, i):
    (n,) = struct.unpack_from("<I", buf, i)
    return buf[i + 4:i + 4 + n].decode("utf-8", "replace"), i + 4 + n


def decode_image(raw: bytes):
    """sensor_msgs/Image -> (numpy image, timestamp, encoding)."""
    import numpy as np

    i = 4  # header.seq
    secs, nsecs = struct.unpack_from("<II", raw, i)
    i += 8
    _, i = _read_string(raw, i)  # frame_id
    h, w = struct.unpack_from("<II", raw, i)
    i += 8
    enc, i = _read_string(raw, i)
    i += 1  # is_bigendian
    (step,) = struct.unpack_from("<I", raw, i)
    i += 4
    (n,) = struct.unpack_from("<I", raw, i)
    i += 4
    data = np.frombuffer(raw, np.uint8, n, i)
    ts = secs + nsecs * 1e-9
    if enc in ("mono8", "8UC1"):
        img = data.reshape(h, step)[:, :w]
    elif enc in ("rgb8", "bgr8"):
        img = data.reshape(h, step // 3, 3)[:, :w] if step >= 3 * w \
            else data.reshape(h, w, 3)
    elif enc in ("16UC1", "mono16"):
        img = data.view("<u2").reshape(h, step // 2)[:, :w]
    elif enc == "32FC1":
        img = data.view("<f4").reshape(h, step // 4)[:, :w]
    else:
        raise NotImplementedError(f"encoding {enc}")
    return img.copy(), ts, enc


def encode_image(img, timestamp: float, encoding: str | None = None) -> bytes:
    import numpy as np

    img = np.asarray(img)
    h, w = img.shape[:2]
    if encoding is None:
        if img.ndim == 2 and img.dtype == np.uint8:
            encoding = "mono8"
        elif img.ndim == 3:
            encoding, img = "rgb8", img.astype(np.uint8)
        elif img.dtype in (np.float32, np.float64):
            encoding, img = "32FC1", img.astype(np.float32)
        else:
            encoding, img = "16UC1", img.astype(np.uint16)
    data = img.tobytes()
    step = len(data) // h
    secs = int(timestamp)
    nsecs = int((timestamp - secs) * 1e9)
    out = struct.pack("<I", 0)  # header.seq
    out += struct.pack("<II", secs, nsecs)
    out += struct.pack("<I", 0)  # empty frame_id
    out += struct.pack("<II", h, w)
    out += struct.pack("<I", len(encoding)) + encoding.encode()
    out += b"\x00"
    out += struct.pack("<I", step)
    out += struct.pack("<I", len(data)) + data
    return out


_IMAGE_MD5 = "060021388200f6f0f447d0fcd9c64743"


class Ros1BagWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(b"#ROSBAG V2.0\n")
        # bag header record padded to 4096 bytes like rosbag does
        hdr = _pack_fields({"op": b"\x03",
                            "index_pos": struct.pack("<Q", 0),
                            "conn_count": struct.pack("<I", 0),
                            "chunk_count": struct.pack("<I", 0)})
        pad = 4096 - len(hdr)
        self.f.write(struct.pack("<I", len(hdr)) + hdr)
        self.f.write(struct.pack("<I", pad) + b" " * pad)
        self._conns: dict[str, int] = {}

    def _record(self, fields: dict, data: bytes):
        hdr = _pack_fields(fields)
        self.f.write(struct.pack("<I", len(hdr)) + hdr)
        self.f.write(struct.pack("<I", len(data)) + data)

    def _connection(self, topic: str, msgtype: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        conn = len(self._conns)
        self._conns[topic] = conn
        data = _pack_fields({"topic": topic.encode(),
                             "type": msgtype.encode(),
                             "md5sum": _IMAGE_MD5.encode(),
                             "message_definition": b""})
        self._record({"op": b"\x07", "conn": struct.pack("<I", conn),
                      "topic": topic.encode()}, data)
        return conn

    def write_image(self, topic: str, img, timestamp: float,
                    encoding: str | None = None):
        conn = self._connection(topic, "sensor_msgs/Image")
        secs = int(timestamp)
        nsecs = int((timestamp - secs) * 1e9)
        self._record({"op": b"\x02", "conn": struct.pack("<I", conn),
                      "time": struct.pack("<II", secs, nsecs)},
                     encode_image(img, timestamp, encoding))

    def close(self):
        self.f.close()


class Ros1BagDataset:
    """Dataset adapter: synchronized (nearest-timestamp) image/right/depth
    streams from a ROS1 bag (reference ``ros1bag_dataset.py`` surface)."""

    def __init__(self, path: str, color_topic: str,
                 right_topic: str | None = None,
                 depth_topic: str | None = None, max_dt: float = 0.05):
        topics = [t for t in (color_topic, right_topic, depth_topic) if t]
        reader = Ros1BagReader(path, topics)
        streams = {t: [m for m in reader.messages if m.topic == t]
                   for t in topics}
        self._color = streams[color_topic]
        self._right = streams.get(right_topic, [])
        self._depth = streams.get(depth_topic, [])
        self.max_dt = max_dt
        self.num_frames = len(self._color)
        if self.num_frames:
            img, _, _ = decode_image(self._color[0].raw)
            self.h, self.w = img.shape[:2]

    def __len__(self):
        return self.num_frames

    def _nearest(self, msgs, ts):
        if not msgs:
            return None
        best = min(msgs, key=lambda m: abs(m.timestamp - ts))
        return best if abs(best.timestamp - ts) <= self.max_dt else None

    def getImage(self, i):
        img, _, _ = decode_image(self._color[i].raw)
        return img

    def getImageRight(self, i):
        m = self._nearest(self._right, self._color[i].timestamp)
        return decode_image(m.raw)[0] if m else None

    def getDepth(self, i):
        m = self._nearest(self._depth, self._color[i].timestamp)
        if m is None:
            return None
        img, _, enc = decode_image(m.raw)
        if enc in ("16UC1", "mono16"):
            return img.astype("float32") / 1000.0  # mm -> m convention
        return img

    def getTimestamp(self, i):
        return self._color[i].timestamp
