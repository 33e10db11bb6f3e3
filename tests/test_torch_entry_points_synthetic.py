"""The port's ``main_slam`` on the synthetic stream on the CPU (``--device
cpu``): a session with a TUM trajectory and a saved state, the semantic
mapper, and a profiler trace (split from tests/test_torch_entry_points.py,
so that the xdist workers share the entry points' time; its autouse
fixture restores the Parameters flags here too)."""

import json
import os

import numpy as np

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu_torch import main_slam
from pyslam_tpu_torch.io.ground_truth import read_tum_trajectory
from tests.test_torch_entry_points import _restore_parameters  # noqa: F401  (autouse fixture)


def test_main_slam_synthetic(tmp_path):
    """The synthetic stream (no --config): every frame tracked, a TUM
    trajectory that reads back, the state and the metrics file."""
    traj, state = str(tmp_path / "traj.txt"), str(tmp_path / "state")
    assert main_slam.main(["--device", "cpu", "--frames", "10", "--save_trajectory", traj,
                           "--save_state", state, "--loop_detector", "DBOW3_INDEPENDENT"]) == 0
    metrics = json.load(open(f"{state}/other_metrics_info.txt"))
    gt = read_tum_trajectory(traj)
    assert len(gt) == metrics["num_tracked"] == 10 and metrics["num_lost"] == 0
    assert np.isfinite(metrics["ate_rmse"]) and np.isfinite(gt.Twc).all()
    assert os.path.exists(f"{state}/map.json")


def test_main_slam_semantics(tmp_path):
    """``--semantics`` (it was refused before the semantic slice): the
    intensity-band mapper labels the keyframes and their points."""
    state = str(tmp_path / "state")
    assert main_slam.main(["--device", "cpu", "--frames", "8", "--semantics",
                           "--no_loop_closing", "--save_state", state]) == 0
    metrics = json.load(open(f"{state}/other_metrics_info.txt"))
    assert metrics["num_tracked"] == 8 and metrics["num_lost"] == 0
    assert 0 < metrics["semantic_keyframes"] <= metrics["num_keyframes"]
    assert metrics["semantic_points"] > 0


def test_main_slam_profile_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    assert main_slam.main(["--device", "cpu", "--frames", "2", "--no_loop_closing",
                           "--profile", logdir]) == 0
    trace = json.load(open(os.path.join(logdir, "trace.json")))
    assert trace["traceEvents"]
