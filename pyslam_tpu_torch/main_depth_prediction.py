"""Depth estimation demo of the port (counterpart of the JAX package's
``main_depth_prediction.py``; reference: pySLAM ``main_depth_prediction.py``).

Runs a depth estimator over the frames of the synthetic stereo stream and
reports, for each, the share of pixels with an estimate and a ground-truth
depth under 20 m and the median relative error there.

    python -m pyslam_tpu_torch.main_depth_prediction --estimator sgbm --frames 5

It runs on the card (``--device cuda``, the default) unless ``--device
cpu`` is given.  Returns the per-frame results (a list of dicts) from
``main`` for callers.
"""

from __future__ import annotations

import argparse

import numpy as np

from pyslam_tpu_torch.depth_estimation.depth_estimator import depth_estimator_factory
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.main_slam import check_device
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.utils.logging import Printer


def run(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m pyslam_tpu_torch.main_depth_prediction")
    ap.add_argument("--estimator", default="sgbm")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(ap, args.device)

    ds = SyntheticDataset(num_frames=args.frames, sensor_type=SensorType.STEREO)
    ds_gt = SyntheticDataset(num_frames=args.frames, sensor_type=SensorType.RGBD)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, bf=ds.fx * ds.baseline)
    est = depth_estimator_factory(args.estimator, camera=cam, max_depth=45.0, device=device)
    out = []
    for i in range(args.frames):
        depth, _ = est.infer(ds.getImage(i), ds.getImageRight(i))
        gt = np.asarray(ds_gt.getDepth(i))
        ok = (depth > 0) & (gt > 0) & (gt < 20)
        row = {"frame": i, "coverage": float(ok.mean()), "median_rel_err": None}
        if ok.sum() > 10:
            rel = np.abs(depth[ok] - gt[ok]) / gt[ok]
            row["median_rel_err"] = float(np.median(rel))
            Printer.green(f"frame {i}: coverage={ok.mean() * 100:.1f}% "
                          f"median rel err={np.median(rel) * 100:.1f}%")
        else:
            Printer.yellow(f"frame {i}: no valid depth overlap")
        out.append(row)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
