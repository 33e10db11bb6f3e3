"""The port's bag and COLMAP I/O (pyslam_tpu_torch/io/{ros1bag,ros2bag,
mcap_io,colmap_io}.py) against the JAX package's, on files under
``tmp_path``.

- ROS 1 bags, ROS 2 bags (sqlite3) and MCAP files of a stereo + depth
  stream, written by either package's writer and read through the other
  package's ``dataset_factory``: the same frames (left, right, depth) and
  timestamps as the writer's own package reads, and the images written,
  tolerance 0.
- COLMAP text models written by either package and read by the other,
  and binary models read by both: the same cameras, images and points.
- ``map_to_colmap`` of a port ``Map`` (a short RGBD session on the CPU):
  the same files from both packages' exporters, read back the same.
"""

import os
import struct

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)
from pyslam_tpu.io import colmap_io as jax_colmap
from pyslam_tpu.io import dataset_factory as jax_factory
from pyslam_tpu.io import mcap_io as jax_mcap
from pyslam_tpu.io import ros1bag as jax_ros1
from pyslam_tpu.io import ros2bag as jax_ros2
from pyslam_tpu_torch.io import colmap_io as port_colmap
from pyslam_tpu_torch.io import dataset_factory as port_factory
from pyslam_tpu_torch.io import mcap_io as port_mcap
from pyslam_tpu_torch.io import ros1bag as port_ros1
from pyslam_tpu_torch.io import ros2bag as port_ros2

N, H, W = 4, 24, 32
PACKAGES = {"jax": (jax_ros1, jax_ros2, jax_mcap, jax_colmap, jax_factory),
            "port": (port_ros1, port_ros2, port_mcap, port_colmap, port_factory)}
TOPICS = {"topic": "/cam/left", "right_topic": "/cam/right", "depth_topic": "/cam/depth"}


def _stream():
    r = np.random.default_rng(3)
    return [(100.0 + 0.1 * i, r.integers(0, 255, (H, W)).astype(np.uint8),
             r.integers(0, 255, (H, W)).astype(np.uint8),
             r.integers(300, 6000, (H, W)).astype(np.uint16)) for i in range(N)]


def _write(pkg, kind, path):
    ros1, ros2, mcap, _, _ = PACKAGES[pkg]
    names = (TOPICS["topic"], TOPICS["right_topic"], TOPICS["depth_topic"])
    if kind == "ros1bag":
        w = ros1.Ros1BagWriter(path)
        for ts, *imgs in _stream():
            for topic, img in zip(names, imgs):
                w.write_image(topic, img, ts + (0.003 if topic == names[2] else 0.0))
        w.close()
    elif kind == "ros2bag":
        w = ros2.Ros2BagWriter(path)
        for topic in names:
            w.add_topic(topic, "sensor_msgs/msg/Image")
        for ts, *imgs in _stream():
            for topic, img in zip(names, imgs):
                enc = "16UC1" if img.dtype == np.uint16 else "mono8"
                w.write(topic, int(round(ts * 1e9)), ros2.encode_image(img, ts, encoding=enc))
        w.close()
    else:
        w = mcap.McapWriter(path)
        sid = w.add_schema("sensor_msgs/msg/Image")
        for topic in names:
            w.add_channel(topic, sid)
        for seq, (ts, *imgs) in enumerate(_stream()):
            for topic, img in zip(names, imgs):
                enc = "16UC1" if img.dtype == np.uint16 else "mono8"
                w.write_message(topic, int(round(ts * 1e9)),
                                ros2.encode_image(img, ts, encoding=enc), seq)
        w.close()


def _read(pkg, kind, path):
    ds = PACKAGES[pkg][4].dataset_factory(dict(TOPICS, type=kind, base_path=path))
    n = ds.num_frames
    return [(ds.getTimestamp(i), ds.getImage(i), ds.getImageRight(i), ds.getDepth(i))
            for i in range(n)]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("kind", ["ros1bag", "ros2bag", "mcap"])
def test_bag_round_trip(kind, writer, reader, tmp_path):
    path = str(tmp_path / {"ros1bag": "seq.bag", "ros2bag": "seq.db3", "mcap": "seq.mcap"}[kind])
    _write(writer, kind, path)
    got, own = _read(reader, kind, path), _read(writer, kind, path)
    assert len(got) == len(own) == N
    for (ts, left, right, depth), (ots, oleft, oright, odepth), (wts, wl, wr, wd) in zip(
            got, own, _stream()):
        assert ts == ots and abs(ts - wts) < 1e-6
        for a, b in ((left, oleft), (right, oright), (depth, odepth)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(np.asarray(left), wl) and np.array_equal(np.asarray(right), wr)
        assert np.array_equal(depth, wd.astype(np.float32) / 1000.0)


def _model(C):
    cams = {1: C.ColmapCamera(1, "PINHOLE", 640, 480, np.array([500.0, 501.0, 320.5, 240.25]))}
    imgs = {
        1: C.ColmapImage(1, C.R_to_qvec(np.eye(3)), np.array([0.1, 0.2, 0.3]), 1, "a.png",
                         np.array([[10.0, 20.0], [30.5, 40.25]]), np.array([7, -1], np.int64)),
        2: C.ColmapImage(2, C.R_to_qvec(C.qvec_to_R(np.array([0.9238795, 0.0, 0.3826834, 0.0]))),
                         np.array([1.0, 0.0, 0.0]), 1, "b c.png"),
    }
    pts = {7: C.ColmapPoint3D(7, np.array([1.0, 2.0, 3.0]), np.array([10, 20, 30], np.uint8),
                              0.5, np.array([1], np.int64), np.array([0], np.int64))}
    return cams, imgs, pts


def _same_model(a, b):
    for da, db in zip(a, b):
        assert sorted(da) == sorted(db)
        for k in da:
            va, vb = vars(da[k]), vars(db[k])
            assert sorted(va) == sorted(vb)
            for f in va:
                x, y = va[f], vb[f]
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype and np.array_equal(x, y), (k, f)
                else:
                    assert x == y, (k, f)


def _write_binary(out):
    """A minimal binary model per the COLMAP specification."""
    with open(out / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, 640, 480)
                + struct.pack("<4d", 500.0, 501.0, 320.5, 240.25))
    with open(out / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<idddddddi", 1, 1, 0, 0, 0, 0.1, 0.2, 0.3, 1)
                + b"a.png\x00" + struct.pack("<Q", 2)
                + struct.pack("<ddq", 10.0, 20.0, 7) + struct.pack("<ddq", 30.5, 40.25, -1))
    with open(out / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<QdddBBBd", 7, 1.0, 2.0, 3.0, 10, 20, 30, 0.5)
                + struct.pack("<Q", 1) + struct.pack("<ii", 1, 0))


@pytest.mark.parametrize("fmt", ["text_by_jax", "text_by_port", "binary"])
def test_colmap_model_round_trip(fmt, tmp_path):
    if fmt == "binary":
        _write_binary(tmp_path)
    else:
        C = jax_colmap if fmt == "text_by_jax" else port_colmap
        C.write_model_text(*_model(C), str(tmp_path))
    got = port_colmap.read_model(str(tmp_path))
    _same_model(got, jax_colmap.read_model(str(tmp_path)))
    assert port_colmap.resolve_colmap_sparse_path(str(tmp_path)) == \
        jax_colmap.resolve_colmap_sparse_path(str(tmp_path))
    assert list(got[1][1].point3D_ids) == [7, -1] and list(got[2][7].image_ids) == [1]


def test_map_to_colmap_of_a_port_map(tmp_path):
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    ds = SyntheticDataset(num_frames=6, sensor_type=SensorType.RGBD, trajectory="line", step=0.3)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, bf=ds.fx * 0.2,
                        depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=500, num_levels=4),
                sensor_type=SensorType.RGBD, device="cpu")
    for i in range(len(ds)):
        slam.track(ds.getImage(i), depth=ds.getDepth(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.finish()
    out = port_colmap.map_to_colmap(slam.map, cam, str(tmp_path / "port"))
    ref = jax_colmap.map_to_colmap(slam.map, cam, str(tmp_path / "jax"))
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    cams, imgs, pts = port_colmap.read_model(out)
    _same_model((cams, imgs, pts), jax_colmap.read_model(out))
    assert len(cams) == 1 and len(imgs) == slam.map.num_keyframes() and len(pts) > 50
    for p in pts.values():
        assert all(i in imgs for i in p.image_ids)
