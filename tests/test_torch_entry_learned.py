"""The port's entry points with the learned presets, on the CPU: a
config.yaml naming SUPERPOINT and the COSPLACE loop detector resolves and
runs through ``main_slam`` (8 frames of tests/test_torch_entry_points.py's
KITTI sequence, 600 SuperPoint keypoints), and ``main_vo --features
LIGHTGLUE`` runs the LightGlue visual odometry on its left images.

A config.yaml naming DISK (seeded random weights) also runs through
``main_slam``, and ``main_vo --features XFEAT_LIGHTGLUE`` runs LightGlue on
XFeat's 64-d descriptors.

Held: the exit codes; the session's tracker and detector are the named
ones with trained weights (SuperPoint float descriptors, the COSPLACE
detector score-based); the saved state's keyframe database holds one
128-d CosPlace descriptor per keyframe and no words; the VO trajectory has
a finite pose a frame.  (SuperPoint does not track this stream in either
package: tests/test_torch_slice_superpoint.py.)
"""

import json

import numpy as np
import pytest

from pyslam_tpu_torch import main_slam, main_vo
from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.io.ground_truth import read_tum_trajectory
from tests.test_torch_entry_points import write_kitti

N_FRAMES = 8


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_learned"))
    return root, write_kitti(root, features="SUPERPOINT", loop="COSPLACE", n_frames=N_FRAMES)


@pytest.fixture(autouse=True)
def _restore_parameters():
    """main_slam applies the yaml's flags, the COSPLACE detector sets
    kRetainImageForVPR, and the SuperPoint session its L2 gates."""
    saved = Parameters.as_dict()
    yield
    Parameters.set_from_dict(saved)


def test_main_slam_superpoint_cosplace(sequence, monkeypatch):
    root, cfg = sequence
    sessions = []
    slam_cls = main_slam.Slam

    def recording_slam(*args, **kw):
        sessions.append(slam_cls(*args, **kw))
        return sessions[-1]

    monkeypatch.setattr(main_slam, "Slam", recording_slam)
    state = f"{root}/state"
    assert main_slam.main(["--config", cfg, "--save_state", state, "--device", "cpu"]) == 0
    slam = sessions[0]
    tracker, lc = slam.feature_tracker, slam.loop_closing
    assert tracker.config.name == "SUPERPOINT" and tracker.extractor.trained
    assert tracker.num_features == 600 and slam.map.points.desc.dtype == np.float32
    assert lc.detector.config.name == "COSPLACE" and lc.detector.score_based
    assert lc.detector.netvlad.trained and Parameters.kRetainImageForVPR
    metrics = json.load(open(f"{state}/other_metrics_info.txt"))
    assert metrics["num_frames"] == N_FRAMES
    z = np.load(f"{state}/loop_closing_state.npz")
    assert z["gdes"].shape == (slam.map.num_keyframes(), 128) and len(z["words_flat"]) == 0
    assert np.allclose(np.linalg.norm(z["gdes"], axis=1), 1.0, atol=1e-5)


def test_main_vo_lightglue(sequence, tmp_path, monkeypatch):
    _, cfg = sequence
    vos = []
    vo_cls = main_vo.VisualOdometry

    def recording_vo(*args, **kw):
        vos.append(vo_cls(*args, **kw))
        return vos[-1]

    monkeypatch.setattr(main_vo, "VisualOdometry", recording_vo)
    traj = str(tmp_path / "vo.txt")
    assert main_vo.main(["--config", cfg, "--features", "LIGHTGLUE", "--num_features", "300",
                         "--save_trajectory", traj, "--device", "cpu"]) == 0
    tracker = vos[0].tracker
    assert tracker.config.name == "LIGHTGLUE" and tracker.num_features == 300
    assert tracker.matcher.glue.trained and tracker.extractor.trained
    est = read_tum_trajectory(traj)
    assert len(est) == N_FRAMES and np.isfinite(est.Twc).all()


def test_main_slam_disk(tmp_path, monkeypatch):
    """A config.yaml naming DISK resolves and runs through ``main_slam``
    (600 keypoints, 128-d float descriptors, random weights)."""
    root = str(tmp_path)
    cfg = write_kitti(root, features="DISK", loop="DBOW3", n_frames=4)
    sessions = []
    slam_cls = main_slam.Slam

    def recording_slam(*args, **kw):
        sessions.append(slam_cls(*args, **kw))
        return sessions[-1]

    monkeypatch.setattr(main_slam, "Slam", recording_slam)
    traj = f"{root}/traj.txt"
    assert main_slam.main(["--config", cfg, "--save_trajectory", traj, "--device", "cpu"]) == 0
    tracker = sessions[0].feature_tracker
    assert tracker.config.name == "DISK" and not tracker.trained
    assert tracker.num_features == 600 and sessions[0].map.points.desc.shape[1] == 128


def test_main_vo_xfeat_lightglue(sequence, tmp_path, monkeypatch):
    _, cfg = sequence
    vos = []
    vo_cls = main_vo.VisualOdometry

    def recording_vo(*args, **kw):
        vos.append(vo_cls(*args, **kw))
        return vos[-1]

    monkeypatch.setattr(main_vo, "VisualOdometry", recording_vo)
    traj = str(tmp_path / "vo.txt")
    assert main_vo.main(["--config", cfg, "--features", "XFEAT_LIGHTGLUE", "--num_features",
                         "300", "--save_trajectory", traj, "--device", "cpu"]) == 0
    tracker = vos[0].tracker
    assert tracker.config.name == "XFEAT_LIGHTGLUE" and tracker.num_features == 300
    assert tracker.matcher.glue.net.input_dim == 64 and not tracker.trained
    est = read_tum_trajectory(traj)
    assert len(est) == N_FRAMES and np.isfinite(est.Twc).all()
