"""The port's one-sequence-a-device evaluation grid
(``SlamEvaluationManager.run_distributed``), the counterpart of
tests/test_eval_distributed.py: cells in two threads sharing the CPU give
results bit-identical to the serial runs that drain the back-end every
frame (ATE with atol 0, keyframes, points, lost share), and the reports are
written."""

import numpy as np

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu_torch.evaluation.manager import EvalConfig, SlamEvaluationManager
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.ops.fast import fast_nms


def _grid(n_seqs: int):
    # distinct synthetic sequences: the step differs, so every cell is a
    # different problem (the reference test's grid)
    return [{"type": "synthetic", "name": f"seq{k}", "num_frames": 10, "sensor_type": "stereo",
             "trajectory": "line", "step": 0.3 + 0.02 * k} for k in range(n_seqs)]


def _run(tmp_path, distributed: bool):
    cfg = EvalConfig(datasets=_grid(3),
                     presets={"orb2": FeatureTrackerConfig(num_features=300, num_levels=4)},
                     runs_per_dataset=1, loop_detector=None)
    mgr = SlamEvaluationManager(cfg, out_dir=str(tmp_path / ("dist" if distributed else "serial")),
                                device="cpu")
    if distributed:
        mgr.run_distributed(devices=["cpu", "cpu"])
    else:
        for ds in cfg.datasets:
            for name, tc in cfg.presets.items():
                mgr.results.append(mgr._single_run(ds, name, tc, 0, deterministic=True))
        mgr.write_reports()
    return {r.dataset: r for r in mgr.results}


def test_distributed_eval_matches_serial(tmp_path):
    serial = _run(tmp_path, distributed=False)
    before = fast_nms.launches
    dist = _run(tmp_path, distributed=True)
    assert fast_nms.launches == before   # the CPU runs the plain version, no kernel
    assert set(serial) == set(dist) and len(serial) == 3
    for name in serial:
        a, b = serial[name], dist[name]
        assert np.isfinite(a.ate_rmse) and a.num_keyframes >= 2, name
        np.testing.assert_allclose(b.ate_rmse, a.ate_rmse, rtol=0, atol=0, err_msg=name)
        assert (b.num_keyframes, b.num_points, b.percent_lost) == \
            (a.num_keyframes, a.num_points, a.percent_lost), name
    for f in ("runs.csv", "table_rmse.csv", "table_percent_lost.csv", "report.md"):
        assert (tmp_path / "dist" / f).exists(), f
