"""Batch evaluation entry point of the port (counterpart of the JAX
package's ``main_slam_evaluation.py``; reference: pySLAM
``main_slam_evaluation.py``).

    python -m pyslam_tpu_torch.main_slam_evaluation                     # synthetic grid
    python -m pyslam_tpu_torch.main_slam_evaluation --config eval.json  # custom grid

Every run of the grid is a ``Slam`` on one device: the card (``--device
cuda``, the default) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from pyslam_tpu_torch.evaluation.manager import EvalConfig, SlamEvaluationManager
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.main_slam import check_device


def default_config(num_frames: int, runs: int) -> EvalConfig:
    return EvalConfig(
        datasets=[
            {"type": "synthetic", "name": "synth_line_stereo", "sensor_type": "stereo",
             "trajectory": "line", "num_frames": num_frames},
            {"type": "synthetic", "name": "synth_line_rgbd", "sensor_type": "rgbd",
             "trajectory": "line", "num_frames": num_frames},
        ],
        presets={"orb2": FeatureTrackerConfig(num_features=600, num_levels=4)},
        runs_per_dataset=runs,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pyslam_tpu_torch.main_slam_evaluation")
    ap.add_argument("--config", default=None, help="json grid config")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--out", default="results/eval")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(ap, args.device)

    cfg = (EvalConfig.from_json(args.config) if args.config
           else default_config(args.frames, args.runs))
    SlamEvaluationManager(cfg, out_dir=args.out, device=device).run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
