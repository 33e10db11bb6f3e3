"""Monocular visual odometry entry point of the port (counterpart of the
JAX package's ``main_vo.py``; reference: pySLAM ``main_vo.py``).

Runs feature-based VO over a dataset, writes the trajectory and reports ATE
against the ground truth.  Defaults to the synthetic sequence:

    python -m pyslam_tpu_torch.main_vo                         # synthetic sequence
    python -m pyslam_tpu_torch.main_vo --config config.yaml    # configured dataset

It runs on the card (``--device cuda``, the default) unless ``--device
cpu`` is given.  ``--features`` names a tracker preset (``LIGHTGLUE``:
SuperPoint keypoints matched by LightGlue), at ``--num_features``; ORB2 and
FAST run on 4 levels.  (The JAX package's ``main_vo.py`` builds
``FeatureTrackerConfig(name=...)`` and so runs ORB2 whatever it is given.)
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from pyslam_tpu_torch.evaluation.metrics import eval_ate
from pyslam_tpu_torch.features.tracker import (
    FeatureTrackerConfig,
    FeatureTrackerConfigs,
    feature_tracker_factory,
)
from pyslam_tpu_torch.io.dataset_factory import dataset_factory
from pyslam_tpu_torch.io.ground_truth import groundtruth_factory
from pyslam_tpu_torch.io.trajectory_writer import TrajectoryWriter
from pyslam_tpu_torch.main_slam import check_device
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.visual_odometry import VisualOdometry
from pyslam_tpu_torch.utils.logging import Printer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pyslam_tpu_torch.main_vo")
    ap.add_argument("--config", default=None, help="yaml config path")
    ap.add_argument("--num_frames", type=int, default=80)
    ap.add_argument("--features", default="ORB2")
    ap.add_argument("--num_features", type=int, default=1000)
    ap.add_argument("--save_trajectory", default=None)
    ap.add_argument("--headless", action="store_true", default=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(ap, args.device)

    if args.config:
        from pyslam_tpu_torch.config import Config

        cfg = Config(args.config)
        dataset = dataset_factory(cfg.dataset_settings)
        gt = groundtruth_factory(cfg.groundtruth_settings)
        cam = cfg.camera
    else:
        dataset = dataset_factory({"type": "synthetic", "num_frames": args.num_frames,
                                   "sensor_type": "mono", "trajectory": "arc"})
        gt = groundtruth_factory({"type": "synthetic", "dataset": dataset})
        cam = PinholeCamera(dataset.w, dataset.h, dataset.fx, dataset.fy, dataset.cx,
                            dataset.cy, fps=dataset.fps)

    try:
        tracker_cfg = dataclasses.replace(FeatureTrackerConfigs.get(args.features),
                                          num_features=args.num_features)
        if tracker_cfg.detector_type.name in ("ORB2", "FAST"):
            tracker_cfg = dataclasses.replace(tracker_cfg, num_levels=4)
    except KeyError:
        tracker_cfg = FeatureTrackerConfig(name=args.features, num_features=args.num_features,
                                           num_levels=4)
    tracker = feature_tracker_factory(tracker_cfg, device=device)
    vo = VisualOdometry(cam, tracker, groundtruth=gt)

    for i in range(len(dataset)):
        img = dataset.getImage(i)
        if img is None:
            break
        vo.track(img, i, dataset.getTimestamp(i))
        if i % 10 == 0:
            Printer.green(f"frame {i}: matches={vo.num_matches} inliers={vo.num_inliers}")

    if args.save_trajectory:
        with TrajectoryWriter("tum", args.save_trajectory) as tw:
            tw.write_full_trajectory(vo.timestamps, vo.poses)

    if gt is not None:
        res = eval_ate(np.asarray(vo.timestamps), vo.trajectory, gt.timestamps, gt.positions,
                       align=True, with_scale=False)
        Printer.blue(str(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
