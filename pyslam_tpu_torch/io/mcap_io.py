"""Minimal pure-Python MCAP reader/writer (ROS2 CDR payloads).
(port of ``pyslam_tpu/io/mcap_io.py``: the same code).

Replaces the reference's mcap stack (pySLAM ``pyslam/io/mcap/`` reader,
writer, syncer — 9 files over the ``mcap`` pip package) with a stdlib
implementation of the MCAP container format: records are
``opcode(1) | content_len(8) | content``; we parse Header / Schema / Channel /
Message / Chunk records (uncompressed chunks natively; lz4/zstd when the
codecs are importable) and write flat uncompressed files.

Payload decoding reuses the CDR codec from ``io/ros2bag.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_FOOTER = 0x02
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_CHUNK = 0x06
OP_DATA_END = 0x0F


def _s(buf, off):
    n = struct.unpack_from("<I", buf, off)[0]
    return buf[off + 4 : off + 4 + n].decode("utf-8", "replace"), off + 4 + n


def _ws(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<I", len(b)) + b


@dataclass
class McapChannel:
    id: int
    schema_id: int
    topic: str
    message_encoding: str


@dataclass
class McapMessage:
    channel: McapChannel
    sequence: int
    log_time: int       # ns
    publish_time: int   # ns
    data: bytes


class McapReader:
    """Sequential reader collecting schemas/channels and yielding messages."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        if self.buf[:8] != MAGIC:
            raise ValueError("not an MCAP file")
        self.schemas = {}
        self.channels: dict[int, McapChannel] = {}

    def _records(self, buf, off, end):
        while off + 9 <= end:
            op = buf[off]
            (ln,) = struct.unpack_from("<Q", buf, off + 1)
            content = buf[off + 9 : off + 9 + ln]
            yield op, content
            off += 9 + ln

    def _decompress(self, compression: str, data: bytes, raw_size: int) -> bytes:
        if compression in ("", None):
            return data
        if compression == "lz4":
            import lz4.frame

            return lz4.frame.decompress(data)
        if compression == "zstd":
            import zstandard

            return zstandard.ZstdDecompressor().decompress(data, max_output_size=raw_size)
        raise ValueError(f"unsupported chunk compression: {compression}")

    def messages(self, topic: str | None = None):
        for op, content in self._records(self.buf, 8, len(self.buf) - 8):
            yield from self._handle(op, content, topic)

    def _handle(self, op, content, topic):
        if op == OP_SCHEMA:
            sid = struct.unpack_from("<H", content, 0)[0]
            name, off = _s(content, 2)
            self.schemas[sid] = name
        elif op == OP_CHANNEL:
            cid, sid = struct.unpack_from("<HH", content, 0)
            t, off = _s(content, 4)
            enc, off = _s(content, off)
            self.channels[cid] = McapChannel(cid, sid, t, enc)
        elif op == OP_MESSAGE:
            cid, seq = struct.unpack_from("<HI", content, 0)
            log_t, pub_t = struct.unpack_from("<QQ", content, 6)
            ch = self.channels.get(cid)
            if ch is not None and (topic is None or ch.topic == topic):
                yield McapMessage(ch, seq, log_t, pub_t, content[22:])
        elif op == OP_CHUNK:
            start_t, end_t, raw_size = struct.unpack_from("<QQQ", content, 0)
            _crc = struct.unpack_from("<I", content, 24)[0]
            compression, off = _s(content, 28)
            (rec_size,) = struct.unpack_from("<Q", content, off)
            recs = self._decompress(
                compression, content[off + 8 : off + 8 + rec_size], raw_size
            )
            for op2, c2 in self._records(recs, 0, len(recs)):
                yield from self._handle(op2, c2, topic)


class McapWriter:
    """Flat (unchunked, uncompressed) MCAP writer."""

    def __init__(self, path: str, profile: str = "ros2"):
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        self._rec(OP_HEADER, _ws(profile) + _ws("pyslam_tpu"))
        self._next_schema = 1
        self._next_channel = 0
        self._schemas = {}
        self._channels = {}

    def _rec(self, op, content: bytes):
        self.f.write(struct.pack("<BQ", op, len(content)) + content)

    def add_schema(self, name: str, encoding: str = "ros2msg",
                   data: bytes = b"") -> int:
        sid = self._next_schema
        self._next_schema += 1
        self._rec(
            OP_SCHEMA,
            struct.pack("<H", sid) + _ws(name) + _ws(encoding)
            + struct.pack("<I", len(data)) + data,
        )
        self._schemas[name] = sid
        return sid

    def add_channel(self, topic: str, schema_id: int,
                    message_encoding: str = "cdr") -> int:
        cid = self._next_channel
        self._next_channel += 1
        self._rec(
            OP_CHANNEL,
            struct.pack("<HH", cid, schema_id) + _ws(topic)
            + _ws(message_encoding) + struct.pack("<I", 0),
        )
        self._channels[topic] = cid
        return cid

    def write_message(self, topic: str, log_time_ns: int, data: bytes,
                      sequence: int = 0):
        cid = self._channels[topic]
        self._rec(
            OP_MESSAGE,
            struct.pack("<HIQQ", cid, sequence, log_time_ns, log_time_ns) + data,
        )

    def close(self):
        self._rec(OP_DATA_END, struct.pack("<I", 0))
        self._rec(OP_FOOTER, struct.pack("<QQI", 0, 0, 0))
        self.f.write(MAGIC)
        self.f.close()


class McapDataset:
    """Dataset over an MCAP file of CDR sensor_msgs/msg/Image messages —
    same surface as the other loaders (reference ``io/mcap_dataset.py``)."""

    def __init__(self, path: str, topic: str, right_topic: str | None = None,
                 depth_topic: str | None = None, sensor_type=None,
                 sync_tol_ms: float = 20.0, depth_factor: float = 1000.0):
        from pyslam_tpu_torch.io.dataset_types import (
            DatasetEnvironmentType, SensorType,
        )
        from pyslam_tpu_torch.io.ros2bag import synchronize

        reader = McapReader(path)
        streams = {topic: []}
        if right_topic:
            streams[right_topic] = []
        if depth_topic:
            streams[depth_topic] = []
        for m in reader.messages():
            if m.channel.topic in streams:
                streams[m.channel.topic].append((m.log_time, m.data))
        for v in streams.values():
            v.sort(key=lambda x: x[0])
        self._frames = synchronize(streams, int(sync_tol_ms * 1e6))
        self._topic, self._right, self._depth = topic, right_topic, depth_topic
        self.num_frames = len(self._frames)
        self.depth_factor = depth_factor
        self.fps = 30.0
        if sensor_type is None:
            sensor_type = (
                SensorType.RGBD if depth_topic
                else SensorType.STEREO if right_topic
                else SensorType.MONOCULAR
            )
        self.sensor_type = sensor_type
        self.environment_type = DatasetEnvironmentType.INDOOR

    def __len__(self):
        return self.num_frames

    def _img(self, i, key):
        from pyslam_tpu_torch.io.ros2bag import decode_image

        if i >= self.num_frames or key is None or key not in self._frames[i]:
            return None
        return decode_image(self._frames[i][key][1]).to_array()

    def getImage(self, i):
        return self._img(i, self._topic)

    def getImageRight(self, i):
        return self._img(i, self._right)

    def getDepth(self, i):
        d = self._img(i, self._depth)
        return None if d is None else d / self.depth_factor

    def getImageColor(self, i):
        return None

    def getTimestamp(self, i):
        return self._frames[i][self._topic][0] * 1e-9

    def isOk(self):
        return True
