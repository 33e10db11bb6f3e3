"""Dense reconstruction from a sparse map, the port's entry point
(counterpart of the JAX package's ``main_map_dense_reconstruction.py``;
reference: pySLAM ``main_map_dense_reconstruction.py``).

Loads a saved system state (``--load_state``) or, without one, builds a
map by RGBD SLAM on the synthetic line; then replays its keyframes, with
each one's depth and image from the dataset by frame id, through the TSDF
integrator and saves the dense cloud.

    python -m pyslam_tpu_torch.main_map_dense_reconstruction --frames 40 --save_cloud dense_cloud.npz

It runs on the card (``--device cuda``, the default) unless ``--device
cpu`` is given.  ``run`` returns (points, colors) to callers.
"""

from __future__ import annotations

import argparse

import numpy as np

from pyslam_tpu_torch.dense.volumetric_integrator import (VolumetricIntegratorType,
                                                          volumetric_integrator_factory)
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.main_slam import check_device
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from pyslam_tpu_torch.utils.logging import Printer


def run(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pyslam_tpu_torch.main_map_dense_reconstruction")
    ap.add_argument("--load_state", default=None)
    ap.add_argument("--save_cloud", default="dense_cloud.npz")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(ap, args.device)

    ds = SyntheticDataset(num_frames=args.frames, sensor_type=SensorType.RGBD, trajectory="line",
                          step=0.3)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * 0.2,
                        depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=600, num_levels=4),
                sensor_type=SensorType.RGBD, device=device)
    if args.load_state:
        slam.load_system_state(args.load_state)
    else:
        for i in range(len(ds)):
            slam.track(ds.getImage(i), depth=ds.getDepth(i), frame_id=i,
                       timestamp=ds.getTimestamp(i))
        Printer.green(f"built map: {slam.map.num_keyframes()} KFs, {slam.map.num_points()} points")

    integrator = volumetric_integrator_factory(VolumetricIntegratorType.TSDF, camera=cam,
                                               environment_type=ds.environment_type,
                                               device=device)
    # replay the keyframes: a saved state keeps the poses, the depth comes
    # from the dataset by frame id, as the reference's replay does
    for kid in slam.map.keyframe_order:
        kf = slam.map.keyframes[kid]
        if kf.id < len(ds):
            integrator.add_keyframe(kf, depth=ds.getDepth(kf.id), intensity=ds.getImage(kf.id))
    integrator.run_all()
    pts, cols = integrator.get_point_cloud()
    Printer.blue(f"dense cloud: {len(pts)} points")
    np.savez_compressed(args.save_cloud, points=pts, colors=cols)
    Printer.green(f"saved -> {args.save_cloud}")
    return pts, cols


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
