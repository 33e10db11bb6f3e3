"""The port's entry points on the CPU (``--device cpu``): ``main_slam``,
``main_vo`` and ``main_slam_evaluation`` called in process, on the
synthetic stream and on a KITTI odometry sequence the test writes (14
frames of the 240x320 straight-line stereo stream, 0.4 m a frame, uint8
PNGs, an ORB-SLAM settings yaml and a config.yaml; 600 ORB2 features on 8
levels, DBOW3).  Held: the exit code, the trajectory and metrics files,
the state folder, every frame tracked and ATE under the 0.25 m floor of
tests/test_slam_e2e.py on the KITTI sequence, and save -> load ->
relocalise (tests/test_map_serialization.py's
test_save_load_system_state_and_extend, which is slow in the JAX
package's suite).  The refusals name the ROADMAP.md item each waits on.
``main_feature_matching`` (tests/test_torch_entry_points_matching.py)
prints the JAX package's lines on the synthetic pair; the synthetic-stream
sessions are in tests/test_torch_entry_points_synthetic.py."""

import json
import os

import numpy as np
import pytest
import yaml
from PIL import Image

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu_torch import main_slam, main_slam_evaluation, main_vo
from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.ground_truth import read_kitti_poses, read_tum_trajectory
from pyslam_tpu_torch.io.synthetic import SyntheticDataset

N_KITTI = 14
ATE_FLOOR = 0.25


@pytest.fixture(autouse=True)
def _restore_parameters():
    """The entry points set Parameters flags (yaml hook, --volumetric)."""
    saved = Parameters.as_dict()
    yield
    Parameters.set_from_dict(saved)


def write_kitti(root, features="ORB2", loop="DBOW3", n_frames=N_KITTI):
    """The line stream (``n_frames`` of it) as KITTI sequence 00 under
    ``root``, its config.yaml naming the ``features`` and ``loop``
    presets; returns the config.yaml path."""
    ds = SyntheticDataset(num_frames=n_frames, sensor_type=SensorType.STEREO,
                          trajectory="line", step=0.4)
    seq = os.path.join(root, "sequences", "00")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, sub))
    os.makedirs(os.path.join(root, "poses"))
    for i in range(n_frames):
        Image.fromarray(ds.getImage(i).astype(np.uint8)).save(f"{seq}/image_0/{i:06d}.png")
        Image.fromarray(ds.getImageRight(i).astype(np.uint8)).save(f"{seq}/image_1/{i:06d}.png")
    np.savetxt(f"{seq}/times.txt", [ds.getTimestamp(i) for i in range(n_frames)], fmt="%.6e")
    np.savetxt(f"{root}/poses/00.txt", ds.poses[:, :3, :].reshape(n_frames, 12))
    bf = ds.fx * ds.baseline
    settings = {"Camera.fx": ds.fx, "Camera.fy": ds.fy, "Camera.cx": ds.cx, "Camera.cy": ds.cy,
                "Camera.width": ds.w, "Camera.height": ds.h, "Camera.fps": ds.fps,
                "Camera.bf": bf, "ThDepth": 20.0 * ds.fx / bf, "ORBextractor.nFeatures": 600}
    with open(f"{root}/settings.yaml", "w") as f:
        f.write("%YAML:1.0\n" + yaml.safe_dump(settings))
    cfg = {"DATASET": {"type": "KITTI"},
           "KITTI": {"type": "kitti", "base_path": root, "name": "00", "sensor_type": "stereo",
                     "settings": "settings.yaml", "groundtruth_file": "poses/00.txt",
                     "FeatureTrackerConfig.name": features, "LoopDetectionConfig.name": loop},
           "GLOBAL_PARAMETERS": {"kVolumetricIntegrationTableCapacity": 1 << 18,
                                 "kVolumetricIntegrationDepthTruncOutdoor": 20.0}}
    with open(f"{root}/config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return f"{root}/config.yaml"


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """main_slam on the KITTI sequence with the TSDF integrator, the state
    saved and a KITTI-format trajectory."""
    root = str(tmp_path_factory.mktemp("kitti"))
    cfg = write_kitti(root)
    saved = Parameters.as_dict()
    state, traj = f"{root}/state", f"{root}/traj_kitti.txt"
    try:
        rc = main_slam.main(["--config", cfg, "--volumetric", "--save_state", state,
                             "--save_trajectory", traj, "--trajectory_format", "kitti",
                             "--print_timings", "--device", "cpu"])
    finally:
        Parameters.set_from_dict(saved)
    return root, cfg, state, traj, rc


def test_main_slam_kitti_sequence(kitti):
    root, _, state, traj, rc = kitti
    assert rc == 0
    metrics = json.load(open(f"{state}/other_metrics_info.txt"))
    assert metrics["num_frames"] == N_KITTI and metrics["num_lost"] == 0
    est = read_kitti_poses(traj)
    assert len(est) == metrics["num_tracked"] >= N_KITTI - 1
    assert metrics["ate_rmse"] < ATE_FLOOR, metrics
    if len(est) == N_KITTI:   # rows are the frames: the same ATE from the file
        from pyslam_tpu_torch.evaluation.metrics import eval_ate

        gt = read_kitti_poses(f"{root}/poses/00.txt", f"{root}/sequences/00/times.txt")
        res = eval_ate(gt.timestamps, est.positions, gt.timestamps, gt.positions)
        assert res.rmse == pytest.approx(metrics["ate_rmse"], abs=1e-6)
    for name in ("map.json", "config_info.json", "loop_closing_state.npz",
                 "loop_vocabulary.npz", "volumetric_state.npz", "other_metrics_info.txt"):
        assert os.path.exists(f"{state}/{name}"), name
    info = json.load(open(f"{state}/config_info.json"))
    assert info["num_keyframes"] == metrics["num_keyframes"] >= 2
    assert np.load(f"{state}/volumetric_state.npz")["occupied"].sum() > 0
    assert set(metrics["stage_totals_ms"]) >= {"tracking", "local_mapping", "loop_closing"}


def test_save_load_relocalise_and_extend(kitti):
    """Save -> load -> the session relocalises into the loaded map and
    continues (the reference's INIT_RELOCALIZE flow), on frames read from
    the sequence."""
    import dataclasses

    from pyslam_tpu_torch.config import Config
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfigs
    from pyslam_tpu_torch.io.dataset_factory import dataset_factory
    from pyslam_tpu_torch.slam.slam import Slam

    _, cfg_path, state, _, _ = kitti
    cfg = Config(cfg_path)
    ds = dataset_factory(cfg.dataset_settings)
    info = json.load(open(f"{state}/config_info.json"))
    tracker_cfg = dataclasses.replace(FeatureTrackerConfigs.ORB2, num_features=cfg.num_features)
    slam = Slam(cfg.camera, tracker_cfg, loop_detector_config="DBOW3",
                sensor_type=SensorType.STEREO, device="cpu")
    slam.load_system_state(state)
    assert slam.map.num_keyframes() == info["num_keyframes"]
    assert slam.map.num_points() == info["num_points"]
    assert slam.state.name == "INIT_RELOCALIZE"
    assert slam.tracking.kf_ref is slam.map.last_keyframe()
    n_kfs = slam.map.num_keyframes()
    states = []
    for i in range(3, 10):
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=100 + i,
                   timestamp=10.0 + ds.getTimestamp(i))
        states.append(slam.state.name)
    assert "OK" in states, states
    first = states.index("OK")
    assert first < 5 and all(st == "OK" for st in states[first:]), states
    assert slam.map.num_keyframes() >= n_kfs


def test_main_slam_load_state(kitti, tmp_path):
    """--load_state: the sequence run again in the loaded map."""
    _, cfg, state, _, _ = kitti
    traj = str(tmp_path / "traj.txt")
    assert main_slam.main(["--config", cfg, "--load_state", state, "--save_trajectory", traj,
                           "--device", "cpu"]) == 0
    assert len(read_tum_trajectory(traj)) >= N_KITTI - 2


def test_main_vo(kitti, tmp_path):
    """The monocular VO on the synthetic arc and on the sequence's left
    images (ground-truth scale from poses/00.txt)."""
    _, cfg, _, _, _ = kitti
    for args in (["--num_frames", "8", "--num_features", "600"], ["--config", cfg]):
        traj = str(tmp_path / "vo.txt")
        assert main_vo.main(args + ["--save_trajectory", traj, "--device", "cpu"]) == 0
        gt = read_tum_trajectory(traj)
        assert len(gt) >= 8 and np.isfinite(gt.Twc).all()


def test_main_slam_evaluation(kitti, tmp_path):
    """The default grid (two synthetic runs) and a json grid naming the
    KITTI sequence, its camera and its ground truth: reports written."""
    root, cfg_path, _, _, _ = kitti
    out = str(tmp_path / "eval")
    assert main_slam_evaluation.main(["--frames", "6", "--out", out, "--device", "cpu"]) == 0
    for name in ("runs.csv", "table_rmse.csv", "table_percent_lost.csv", "report.md",
                 "report.tex", "report.html", "report.pdf"):
        assert os.path.exists(f"{out}/{name}"), name
    assert len(open(f"{out}/runs.csv").read().splitlines()) == 3
    from pyslam_tpu_torch.config import Config

    cam = Config(cfg_path).camera.to_json()
    grid = {"number_of_runs_per_dataset": 1, "loop_detector": "DBOW3",
            "datasets": [{"type": "kitti", "base_path": root, "name": "00",
                          "sensor_type": "stereo", "camera": cam,
                          "groundtruth": {"type": "kitti", "path": f"{root}/poses/00.txt",
                                          "times_path": f"{root}/sequences/00/times.txt"}}],
            "presets": {"orb2": {"name": "ORB2", "num_features": 600, "num_levels": 4}}}
    gpath = str(tmp_path / "grid.json")
    json.dump(grid, open(gpath, "w"))
    out2 = str(tmp_path / "eval2")
    assert main_slam_evaluation.main(["--config", gpath, "--out", out2, "--device", "cpu"]) == 0
    rows = open(f"{out2}/runs.csv").read().splitlines()
    assert len(rows) == 2 and rows[1].startswith("00,orb2,0,")
    assert float(rows[1].split(",")[3]) < ATE_FLOOR and float(rows[1].split(",")[5]) == 0.0


@pytest.mark.parametrize("args,item", [
    (["--depth_estimator", "no_such_estimator"], "one of sgbm, depth_anything_v2"),
    (["--config", "mono_kitti", "--depth_estimator", "sgbm"], "needs a stereo pair"),
])
def test_main_slam_refusals_name_their_item(args, item, capsys, request):
    if "mono_kitti" in args:
        # the KITTI sequence read as monocular: no right image for SGBM
        root, cfg_path = request.getfixturevalue("kitti")[:2]
        cfg = yaml.safe_load(open(cfg_path))
        cfg["KITTI"]["sensor_type"] = "mono"
        mono = os.path.join(root, "config_mono.yaml")
        with open(mono, "w") as f:
            yaml.safe_dump(cfg, f)
        args = [mono if a == "mono_kitti" else a for a in args]
    with pytest.raises(SystemExit) as e:
        main_slam.main(args + ["--device", "cpu", "--frames", "2"])
    assert e.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("entry", [main_slam, main_vo, main_slam_evaluation])
def test_entry_points_default_to_the_card(entry, capsys):
    """--device defaults to cuda; without a card that is an error, never a
    run on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(SystemExit) as e:
        entry.main(["--frames", "2"] if entry is not main_vo else ["--num_frames", "2"])
    assert e.value.code == 2 and "no CUDA device" in capsys.readouterr().err
