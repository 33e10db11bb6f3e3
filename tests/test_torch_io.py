"""The port's host I/O against the JAX package's on the same files: every
dataset loader (images, colour, depth and timestamps identical, tolerance
0), every ground-truth reader (arrays identical), the trajectory writer's
bytes, the yaml ``Config``, the evaluation grids and report writers, and
``Parameters``' yaml hook.  The files are written under ``tmp_path``."""

import json
import os

import numpy as np
import pytest
from PIL import Image

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu.io import dataset_factory as jax_factory_mod
from pyslam_tpu.io import ground_truth as jax_gt
from pyslam_tpu_torch.io import dataset_factory as port_factory_mod
from pyslam_tpu_torch.io import ground_truth as port_gt

H, W = 24, 32


def _png(path, arr, mode=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr, mode=mode).save(path) if mode else Image.fromarray(arr).save(path)


def _gray(r, i=0):
    return r.integers(0, 255, (H, W)).astype(np.uint8) + np.uint8(i)


def _rgb(r):
    return r.integers(0, 255, (H, W, 3)).astype(np.uint8)


def _depth16(r):
    return r.integers(500, 5000, (H, W)).astype(np.uint16)


def _write_kitti(root, r, n=3, times=True):
    seq = f"{root}/sequences/00"
    for i in range(n):
        _png(f"{seq}/image_0/{i:06d}.png", _gray(r, i))
        _png(f"{seq}/image_1/{i:06d}.png", _gray(r, i))
    if times:
        np.savetxt(f"{seq}/times.txt", np.arange(n) * 0.1037, fmt="%.6e")
    return {"type": "kitti", "base_path": root, "name": "00", "sensor_type": "stereo"}


def _write_tum(root, r, kind="tum"):
    seq = f"{root}/seq"
    os.makedirs(seq, exist_ok=True)
    rgb_lines, depth_lines = ["# rgb"], ["# depth"]
    for i in range(4):
        t = 1305031102.175304 + i * 0.0333
        _png(f"{seq}/rgb/{t:.6f}.png", _rgb(r))
        _png(f"{seq}/depth/{t + 0.011:.6f}.png", _depth16(r))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t + 0.011:.6f} depth/{t + 0.011:.6f}.png")
    # a depth frame with no rgb partner, and one far outside the tolerance
    depth_lines.append("1305031109.000000 depth/none.png")
    open(f"{seq}/rgb.txt", "w").write("\n".join(rgb_lines) + "\n")
    open(f"{seq}/depth.txt", "w").write("\n".join(depth_lines) + "\n")
    return {"type": kind, "base_path": root, "name": "seq", "sensor_type": "rgbd"}


def _write_euroc(root, r):
    seq = f"{root}/MH_01/mav0"
    for i in range(3):
        ts = 1403636579763555584 + i * 50000000
        _png(f"{seq}/cam0/data/{ts}.png", _gray(r))
        _png(f"{seq}/cam1/data/{ts}.png", _gray(r))
    return {"type": "euroc", "base_path": root, "name": "MH_01", "sensor_type": "stereo"}


def _write_folder(root, r):
    for i in range(3):
        _png(f"{root}/imgs/{i:04d}.png", _rgb(r) if i == 1 else _gray(r))
    # a 16-bit frame is kept in its own mode (I;16), as the reference keeps it
    _png(f"{root}/imgs/0003.png", _depth16(r))
    return {"type": "folder", "base_path": f"{root}/imgs", "glob": "*.png", "fps": 15.0}


def _write_replica(root, r):
    for i in range(3):
        _png(f"{root}/results/frame{i:06d}.png", _rgb(r))
        _png(f"{root}/results/depth{i:06d}.png", _depth16(r))
    return {"type": "replica", "base_path": root, "sensor_type": "rgbd"}


def _write_tartanair(root, r):
    for i in range(2):
        _png(f"{root}/image_left/{i:06d}_left.png", _rgb(r))
        _png(f"{root}/image_right/{i:06d}_right.png", _rgb(r))
        os.makedirs(f"{root}/depth_left", exist_ok=True)
        np.save(f"{root}/depth_left/{i:06d}_left_depth.npy",
                r.uniform(1, 20, (H, W)).astype(np.float32))
    return {"type": "tartanair", "base_path": root, "sensor_type": "rgbd"}


def _write_scannet(root, r):
    for i in range(11):   # numeric order, not lexical
        _png(f"{root}/color/{i}.png", _gray(r, i))
        _png(f"{root}/depth/{i}.png", _depth16(r))
    return {"type": "scannet", "base_path": root, "sensor_type": "rgbd"}


def _write_seven_scenes(root, r):
    for i in range(2):
        d = _depth16(r)
        d[0, 0] = 65535   # the invalid marker
        _png(f"{root}/seq-01/frame-{i:06d}.color.png", _rgb(r))
        _png(f"{root}/seq-01/frame-{i:06d}.depth.png", d)
    return {"type": "seven_scenes", "base_path": root, "sequence": "seq-01",
            "sensor_type": "rgbd"}


def _write_neural_rgbd(root, r):
    for i in range(2):
        _png(f"{root}/images/img{i:04d}.png", _rgb(r))
        _png(f"{root}/depth/depth{i:04d}.png", _depth16(r))
    return {"type": "neural_rgbd", "base_path": root, "sensor_type": "rgbd"}


def _write_clio(root, r):
    for i in (0, 1, 2, 5):   # non-contiguous ids, as real bags
        _png(f"{root}/scene/images/rgb_{i}.jpg", _rgb(r))
        if i != 2:           # a frame without its depth file
            _png(f"{root}/scene/depth/depth_{i}.png", _depth16(r))
    return {"type": "clio", "base_path": f"{root}/scene", "sensor_type": "rgbd", "fps": 5.0}


def _write_rover(root, r):
    cam = f"{root}/seq1/cam0"
    lines = ["# timestamp rgb timestamp depth"]
    for i in range(3):
        _png(f"{cam}/rgb/{i}.png", _rgb(r))
        _png(f"{cam}/depth/{i}.png", _depth16(r))
        lines.append(f"{100.0 + i * 0.1:.4f} rgb/{i}.png {100.0 + i * 0.1:.4f} depth/{i}.png")
    lines.append("100.3000 rgb/0.png")   # a row without depth
    open(f"{cam}/associations.txt", "w").write("\n".join(lines) + "\n")
    return {"type": "rover", "base_path": root, "name": "seq1", "camera_name": "cam0",
            "sensor_type": "rgbd"}


def _write_icl(root, r):
    return _write_tum(root, r, kind="icl_nuim")


def _write_mono_kitti(root, r):
    d = _write_kitti(root, r, times=False)
    d["sensor_type"] = "mono"
    return d


LOADERS = {"kitti": _write_kitti, "kitti_mono_no_times": _write_mono_kitti, "tum": _write_tum,
           "euroc": _write_euroc, "icl_nuim": _write_icl, "folder": _write_folder,
           "replica": _write_replica, "tartanair": _write_tartanair, "scannet": _write_scannet,
           "seven_scenes": _write_seven_scenes, "neural_rgbd": _write_neural_rgbd,
           "clio": _write_clio, "rover": _write_rover}


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_identical_to_reference(name, tmp_path):
    """Every frame's grey image, colour image, right image, depth and
    timestamp identical (dtype, shape and values) to the JAX loader's."""
    settings = LOADERS[name](str(tmp_path), np.random.default_rng(3))
    jds = jax_factory_mod.dataset_factory(dict(settings))
    pds = port_factory_mod.dataset_factory(dict(settings))
    assert type(pds).__name__ == type(jds).__name__
    assert len(pds) == len(jds) > 0
    assert pds.sensor_type.name == jds.sensor_type.name
    assert pds.environment_type.name == jds.environment_type.name
    assert pds.fps == jds.fps and pds.depth_factor == jds.depth_factor
    for i in range(len(jds)):
        for getter in ("getImage", "getImageColor", "getImageRight", "getDepth"):
            _same(getattr(pds, getter)(i), getattr(jds, getter)(i), (name, getter, i))
        assert pds.getTimestamp(i) == jds.getTimestamp(i)
    # the iteration surface
    first = next(iter(pds))
    _same(first[1], next(iter(jds))[1], (name, "__iter__"))


def test_kitti_grey_is_float32_of_the_png(tmp_path):
    """The decode is PIL's: a uint8 PNG comes back as its float32 values."""
    r = np.random.default_rng(0)
    settings = _write_kitti(str(tmp_path), r)
    ds = port_factory_mod.dataset_factory(settings)
    png = np.asarray(Image.open(ds.left[1]))
    img = ds.getImage(1)
    assert img.dtype == np.float32 and np.array_equal(img, png.astype(np.float32))


def test_video_loader_matches_reference(tmp_path):
    """Video through imageio: the same frames, or the same refusal."""
    path = str(tmp_path / "clip.gif")
    r = np.random.default_rng(1)
    frames = [_rgb(r) for _ in range(3)]
    try:
        import imageio.v3 as iio

        iio.imwrite(path, np.stack(frames))
    except Exception:
        open(path, "wb").write(b"not a video")
    settings = {"type": "video", "base_path": path, "fps": 12.0}
    try:
        jds = jax_factory_mod.dataset_factory(dict(settings))
    except RuntimeError:
        with pytest.raises(RuntimeError):
            port_factory_mod.dataset_factory(dict(settings))
        return
    pds = port_factory_mod.dataset_factory(dict(settings))
    assert len(pds) == len(jds)
    for i in range(len(jds)):
        _same(pds.getImage(i), jds.getImage(i), ("video", i))


@pytest.mark.parametrize("kind", ["ros1bag", "ros2bag", "mcap"])
def test_bag_readers_name_their_roadmap_item(kind, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 4"):
        port_factory_mod.dataset_factory({"type": kind, "base_path": str(tmp_path),
                                          "topic": "/cam"})


def test_synthetic_through_the_factory_is_the_reference_stream():
    settings = {"type": "synthetic", "num_frames": 3, "sensor_type": "rgbd",
                "trajectory": "line", "step": 0.4}
    jds = jax_factory_mod.dataset_factory(dict(settings))
    pds = port_factory_mod.dataset_factory(dict(settings))
    from pyslam_tpu_torch.io import dataset, synthetic

    assert dataset.SyntheticDataset is synthetic.SyntheticDataset
    assert isinstance(pds, dataset.DatasetBase)
    assert np.array_equal(pds.poses, jds.poses)
    _same(pds.getImage(2), jds.getImage(2), "synthetic image")
    _same(pds.getDepth(2), jds.getDepth(2), "synthetic depth")


# ---------------------------------------------------------------- ground truth

def _random_twc(r, n):
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q = r.normal(size=4)
        q /= np.linalg.norm(q)
        T[i, :3, :3] = jax_gt._quat_to_R(q)
        T[i, :3, 3] = r.normal(size=3) * 5
    return T


def _gt_files(root):
    """One file (or folder) per reader: (settings without 'type', type)."""
    r = np.random.default_rng(7)
    n = 6
    T = _random_twc(r, n)
    q = np.stack([jax_gt._R_to_quat(T[i, :3, :3]) for i in range(n)])
    out = {}
    np.savetxt(f"{root}/kitti.txt", T[:, :3, :].reshape(n, 12))
    np.savetxt(f"{root}/times.txt", np.arange(n) * 0.1037)
    out["kitti"] = {"path": f"{root}/kitti.txt", "times_path": f"{root}/times.txt"}
    out["kitti_no_times"] = {"path": f"{root}/kitti.txt"}
    with open(f"{root}/tum.txt", "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(n):
            x, y, z = T[i, :3, 3]
            f.write(f"{i * 0.1} {x} {y} {z} {q[i, 0]} {q[i, 1]} {q[i, 2]} {q[i, 3]}\n")
    out["tum"] = {"path": f"{root}/tum.txt"}
    out["simple"] = {"path": f"{root}/tum.txt"}
    out["icl_nuim"] = {"path": f"{root}/tum.txt"}
    with open(f"{root}/euroc.csv", "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v_x\n")
        for i in range(n):
            x, y, z = T[i, :3, 3]
            f.write(f"{1403636579763555584 + i * 5000000},{x},{y},{z},"
                    f"{q[i, 3]},{q[i, 0]},{q[i, 1]},{q[i, 2]},0.0\n")
    out["euroc"] = {"path": f"{root}/euroc.csv"}
    np.savetxt(f"{root}/traj.txt", T.reshape(n, 16))
    out["replica"] = {"path": f"{root}/traj.txt", "fps": 30.0}
    np.savetxt(f"{root}/pose_left.txt", np.concatenate([T[:, :3, 3], q], axis=1))
    out["tartanair"] = {"path": f"{root}/pose_left.txt"}
    os.makedirs(f"{root}/pose", exist_ok=True)
    for i in range(n):
        np.savetxt(f"{root}/pose/{i}.txt", T[i])
    np.savetxt(f"{root}/pose/{n}.txt", np.full((4, 4), -np.inf))
    out["scannet"] = {"path": f"{root}/pose"}
    os.makedirs(f"{root}/7s/seq-01", exist_ok=True)
    for i in range(n):
        np.savetxt(f"{root}/7s/seq-01/frame-{i:06d}.pose.txt", T[i])
    out["seven_scenes"] = {"path": f"{root}/7s", "fps": 15.0}
    np.savetxt(f"{root}/poses.txt", np.concatenate([T.reshape(-1, 4), np.full((4, 4), np.nan)]))
    out["neural_rgbd"] = {"path": f"{root}/poses.txt"}
    return out


GT_KINDS = ["kitti", "kitti_no_times", "tum", "simple", "icl_nuim", "euroc", "replica",
            "tartanair", "scannet", "seven_scenes", "neural_rgbd"]


@pytest.mark.parametrize("kind", GT_KINDS)
def test_groundtruth_reader_identical(kind, tmp_path):
    settings = dict(_gt_files(str(tmp_path))[kind])
    settings["type"] = kind.replace("_no_times", "")
    gj = jax_gt.groundtruth_factory(dict(settings))
    gp = port_gt.groundtruth_factory(dict(settings))
    assert len(gp) == len(gj) > 0
    _same(gp.timestamps, gj.timestamps, "timestamps")
    _same(gp.Twc, gj.Twc, "Twc")
    _same(gp.positions, gj.positions, "positions")
    for t in (0.0, 0.26, 99.0):
        assert np.array_equal(gp.pose_at(t)[0], gj.pose_at(t)[0])
    assert gp.trajectory_scale(2) == gj.trajectory_scale(2)


def test_groundtruth_factory_none_synthetic_and_unknown():
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset

    assert port_gt.groundtruth_factory({}) is None
    assert port_gt.groundtruth_factory({"type": "none"}) is None
    ds = SyntheticDataset(num_frames=4)
    gt = port_gt.groundtruth_factory({"type": "synthetic", "dataset": ds})
    assert np.array_equal(gt.Twc, ds.poses)
    with pytest.raises(ValueError):
        port_gt.groundtruth_factory({"type": "bogus"})


# ------------------------------------------------------------ trajectory writer

@pytest.mark.parametrize("fmt", ["tum", "kitti", "euroc"])
def test_trajectory_writer_bytes(fmt, tmp_path):
    from pyslam_tpu.io.trajectory_writer import TrajectoryWriter as JaxWriter
    from pyslam_tpu_torch.io.trajectory_writer import TrajectoryWriter

    r = np.random.default_rng(11)
    T = _random_twc(r, 7)
    ts = 1403636579.76 + np.arange(7) * 0.05
    pj, pp = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    with JaxWriter(fmt, pj) as w:
        w.write_full_trajectory(ts, T)
    with TrajectoryWriter(fmt, pp) as w:
        w.write_full_trajectory(ts, T)
    assert open(pp, "rb").read() == open(pj, "rb").read()
    if fmt == "tum":   # and it reads back
        np.testing.assert_allclose(port_gt.read_tum_trajectory(pp).Twc, T, atol=1e-6)


# ------------------------------------------------------------------- config

def _write_config(root, with_gt_block=False, overrides=None):
    settings = ("%YAML:1.0\n---\nCamera.fx: 718.856\nCamera.fy: 718.856\nCamera.cx: 607.1928\n"
                "Camera.cy: 185.2157\nCamera.k1: -0.1\nCamera.k2: 0.01\nCamera.p1: 0.0\n"
                "Camera.p2: 0.0\nCamera.width: 1241\nCamera.height: 376\nCamera.fps: 10.0\n"
                "Camera.bf: 386.1448\nThDepth: 35.0\nDepthMapFactor: 1000.0\n"
                "ORBextractor.nFeatures: 1500\nK: !!opencv-matrix\n  rows: 1\n  cols: 1\n"
                "  dt: d\n  data: [1.0]\n")
    open(f"{root}/KITTI00-02.yaml", "w").write(settings)
    cfg = {"DATASET": {"type": "KITTI"},
           "KITTI": {"type": "kitti", "base_path": root, "name": "00", "sensor_type": "stereo",
                     "settings": "KITTI00-02.yaml", "groundtruth_file": "poses/00.txt",
                     "FeatureTrackerConfig.name": "ORB2_BEBLID",
                     "LoopDetectionConfig.name": "DBOW3_INDEPENDENT"}}
    if with_gt_block:
        cfg["GROUNDTRUTH"] = {"type": "tum", "path": "/data/gt.txt"}
    if overrides:
        cfg["GLOBAL_PARAMETERS"] = overrides
    import yaml

    path = f"{root}/config.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.mark.parametrize("gt_block", [False, True])
def test_config_identical_to_reference(gt_block, tmp_path):
    from pyslam_tpu.config import Config as JaxConfig
    from pyslam_tpu_torch.config import Config

    path = _write_config(str(tmp_path), with_gt_block=gt_block)
    cj, cp = JaxConfig(path), Config(path)
    assert cp.dataset_settings == cj.dataset_settings
    assert cp.camera_settings == cj.camera_settings
    assert cp.camera.to_json() == cj.camera.to_json()
    assert cp.camera.depth_threshold == pytest.approx(386.1448 * 35.0 / 718.856, rel=1e-15)
    assert cp.num_features == cj.num_features == 1500
    assert cp.feature_tracker_config_name == cj.feature_tracker_config_name == "ORB2_BEBLID"
    assert cp.loop_detection_config_name == cj.loop_detection_config_name
    assert cp.groundtruth_settings == cj.groundtruth_settings
    assert cp.sensor_type == cj.sensor_type == "stereo"
    assert cp.system_state_settings == cj.system_state_settings


def test_config_global_parameters_hook(tmp_path):
    from pyslam_tpu_torch.config import Config
    from pyslam_tpu_torch.config_parameters import Parameters

    saved = Parameters.as_dict()
    try:
        Config(_write_config(str(tmp_path), overrides={"kVolumetricIntegrationVoxelSize": 0.2,
                                                       "kNumFeatures": 1234}))
        assert Parameters.kVolumetricIntegrationVoxelSize == 0.2
        assert Parameters.kNumFeatures == 1234
        with pytest.raises(KeyError):
            Config(_write_config(str(tmp_path), overrides={"kNoSuchFlag": 1}))
    finally:
        Parameters.set_from_dict(saved)
    assert Parameters.as_dict() == saved


def test_parameters_share_the_reference_values():
    """Every flag the port keeps has the JAX package's value."""
    from pyslam_tpu.config_parameters import Parameters as JaxParameters
    from pyslam_tpu_torch.config_parameters import Parameters

    port = Parameters.as_dict()
    ref = JaxParameters.as_dict()
    assert port and set(port) <= set(ref)
    assert {k: v for k, v in port.items()} == {k: ref[k] for k in port}


def test_camera_json_round_trip_across_packages():
    from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
    from pyslam_tpu_torch.slam.camera import PinholeCamera

    kw = dict(D=[0.1, -0.02, 0.001, 0.0, 0.003], fps=20.0, bf=40.0, depth_factor=5000.0,
              depth_threshold=7.5)
    cj = JaxCamera(640, 480, 517.3, 516.5, 318.6, 255.3, **kw)
    cp = PinholeCamera(640, 480, 517.3, 516.5, 318.6, 255.3, **kw)
    assert cp.to_json() == cj.to_json()
    back = PinholeCamera.from_json(json.loads(json.dumps(cj.to_json())))
    assert back.to_json() == cj.to_json()
    assert (back.u_min, back.u_max, back.v_min, back.v_max) == (cp.u_min, cp.u_max, cp.v_min,
                                                                cp.v_max)
    assert JaxCamera.from_json(cp.to_json()).to_json() == cp.to_json()


# --------------------------------------------------------------- evaluation

@pytest.mark.parametrize("name,n_datasets", [("kitti", 11), ("tum", 5), ("euroc", 6)])
def test_evaluation_grid_configs_parse(name, n_datasets):
    from pyslam_tpu.evaluation.manager import EvalConfig as JaxEvalConfig
    from pyslam_tpu_torch.evaluation.manager import EvalConfig

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port_path = os.path.join(root, "pyslam_tpu_torch", "evaluation", "configs",
                             f"evaluation_{name}.json")
    jax_path = os.path.join(root, "pyslam_tpu", "evaluation", "configs",
                            f"evaluation_{name}.json")
    assert open(port_path).read() == open(jax_path).read()
    cp, cj = EvalConfig.from_json(port_path), JaxEvalConfig.from_json(jax_path)
    assert len(cp.datasets) == n_datasets and cp.datasets == cj.datasets
    assert cp.runs_per_dataset == cj.runs_per_dataset == 5
    assert cp.loop_detector == cj.loop_detector
    assert {k: v.to_json() for k, v in cp.presets.items()} == \
        {k: v.to_json() for k, v in cj.presets.items()}


@pytest.mark.parametrize("writer", ["csv_list_to_latex", "csv_list_to_html",
                                    "csv_list_to_pdf"])
def test_report_writers_bytes(writer, tmp_path):
    from pyslam_tpu.evaluation import report_formats as jax_rf
    from pyslam_tpu_torch.evaluation import report_formats as port_rf

    rows = ["dataset,orb2,sift", "kitti_00,0.1234,0.2345", "tum_fr1_desk,(n/a),0.0100"]
    rows += [f"synth_{i},{i * 0.01:.4f},{i * 0.02:.4f}" for i in range(70)]   # two PDF pages
    csv = tmp_path / "table_rmse.csv"
    csv.write_text("\n".join(rows) + "\n")
    getattr(jax_rf, writer)([str(csv)], str(tmp_path / "jax.out"))
    getattr(port_rf, writer)([str(csv)], str(tmp_path / "port.out"))
    assert (tmp_path / "port.out").read_bytes() == (tmp_path / "jax.out").read_bytes()
