"""Full SLAM entry point of the port (counterpart of the JAX package's
``main_slam.py``; reference: pySLAM ``main_slam.py``).

Runs the pipeline — tracking, local mapping, loop closing and optionally
volumetric integration and semantic mapping — over a configured or synthetic dataset on one
device, writes the trajectory, evaluates ATE, and optionally saves the
system state (``map.json`` and the rest, with ``other_metrics_info.txt``).

    python -m pyslam_tpu_torch.main_slam                        # synthetic stereo demo
    python -m pyslam_tpu_torch.main_slam --config config.yaml   # configured dataset
    python -m pyslam_tpu_torch.main_slam --sensor rgbd --frames 120 --device cpu

It runs on the card (``--device cuda``, the default) unless ``--device
cpu`` is given.  ``--depth_estimator TYPE`` on a monocular stream upgrades
the session to RGBD with that estimator's per-frame depth (as the
reference's ``main_slam.py``); on a stereo stream with ``--volumetric`` it
is the integrator's estimator.  A stereo estimator (``sgbm``, or
``raft_stereo`` / ``crestereo`` routed to it without weights) needs the
right image: the synthetic demo stream renders it for ``--sensor mono``
(the reference's stream has none and its SGBM stops there), a configured
monocular dataset without one is refused.  ``--semantics`` attaches the
semantic mapper (``semantic_mapping_factory(slam.map)``: the weight-free
intensity bands, as the reference's default), which labels each keyframe
and its map points.  ``--viewer`` is refused with the ROADMAP.md item it
waits on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.evaluation.metrics import eval_ate
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, FeatureTrackerConfigs
from pyslam_tpu_torch.io.dataset_factory import dataset_factory
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.ground_truth import groundtruth_factory
from pyslam_tpu_torch.io.trajectory_writer import TrajectoryWriter
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from pyslam_tpu_torch.utils.logging import Printer
from pyslam_tpu_torch.utils.timer import TimerFps

SENSORS = {"mono": SensorType.MONOCULAR, "stereo": SensorType.STEREO, "rgbd": SensorType.RGBD}
VIEWER_ITEM = "ROADMAP.md section 1 item 4.2 (viz/: html_viewer, live_viewer, viewer3d)"
# latency percentiles skip the first frames (initialisation, first keyframes)
LATENCY_SKIP = 10


def check_device(ap: argparse.ArgumentParser, device: str) -> torch.device:
    """The device the caller asked for; a missing card is an error, never a
    silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the port runs on the card unless --device cpu is given")
    return dev


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pyslam_tpu_torch.main_slam")
    ap.add_argument("--config", default=None)
    ap.add_argument("--sensor", default="stereo", choices=["mono", "stereo", "rgbd"])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--features", default="ORB2")
    ap.add_argument("--num_features", type=int, default=800)
    ap.add_argument("--loop_detector", default="DBOW3")
    ap.add_argument("--no_loop_closing", action="store_true")
    ap.add_argument("--volumetric", action="store_true",
                    help="run TSDF integration on keyframes (rgbd natively; stereo through "
                         "the integrator's SGM depth)")
    ap.add_argument("--depth_estimator", default=None, metavar="TYPE",
                    help="a DepthEstimatorType value (sgbm, depth_anything_v2, "
                         "depth_anything_v3, depth_pro, raft_stereo, crestereo, mast3r, "
                         "mvdust3r): upgrades a monocular session to RGBD, and is the "
                         "integrator's estimator for --volumetric on stereo or mono")
    ap.add_argument("--semantics", action="store_true",
                    help="semantic mapping: segment keyframes, fuse labels into map points")
    ap.add_argument("--save_state", default=None, help="folder for map.json")
    ap.add_argument("--load_state", default=None)
    ap.add_argument("--save_trajectory", default=None)
    ap.add_argument("--trajectory_format", default="tum", choices=["tum", "kitti", "euroc"])
    ap.add_argument("--headless", action="store_true", default=True)
    ap.add_argument("--viewer", action="store_true", help=f"not ported: {VIEWER_ITEM}")
    ap.add_argument("--viewer_port", type=int, default=8090)
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="capture a torch.profiler trace into LOGDIR/trace.json "
                         "(Chrome/Perfetto viewable)")
    ap.add_argument("--print_timings", action="store_true",
                    help="print per-stage timings at the end")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.viewer:
        ap.error(f"--viewer is not ported yet: {VIEWER_ITEM}")
    device = check_device(ap, args.device)
    stereo_estimator = False
    if args.depth_estimator:
        from pyslam_tpu_torch.depth_estimation.depth_estimator import DepthEstimatorType

        try:
            est_type = DepthEstimatorType(args.depth_estimator.lower())
        except ValueError:
            ap.error(f"--depth_estimator {args.depth_estimator}: one of "
                     f"{', '.join(t.value for t in DepthEstimatorType)}")
        stereo_estimator = est_type in (
            DepthEstimatorType.DEPTH_SGBM, DepthEstimatorType.DEPTH_RAFT_STEREO,
            DepthEstimatorType.DEPTH_CRESTEREO_PYTORCH,
            DepthEstimatorType.DEPTH_CRESTEREO_MEGENGINE)

    # ------------------------------------------------------------- dataset
    if args.config:
        from pyslam_tpu_torch.config import Config

        cfg = Config(args.config)
        dataset = dataset_factory(cfg.dataset_settings)
        gt = groundtruth_factory(cfg.groundtruth_settings)
        camera = cfg.camera
        sensor = SENSORS[cfg.sensor_type]
        tracker_cfg = dataclasses.replace(
            FeatureTrackerConfigs.get(cfg.feature_tracker_config_name),
            num_features=cfg.num_features)
        loop_cfg = cfg.loop_detection_config_name
    else:
        sensor = SENSORS[args.sensor]
        # a stereo estimator on the monocular demo stream takes the right
        # image the stream renders for it
        render = "stereo" if sensor == SensorType.MONOCULAR and stereo_estimator \
            else args.sensor
        dataset = dataset_factory(
            # period bounds the yaw rate (360/period deg per frame), as the
            # JAX package's main_slam.py sets it
            {"type": "synthetic", "num_frames": args.frames, "sensor_type": render,
             "trajectory": "loop", "period": max(args.frames - 15, 120)})
        gt = groundtruth_factory({"type": "synthetic", "dataset": dataset})
        camera = PinholeCamera(dataset.w, dataset.h, dataset.fx, dataset.fy, dataset.cx,
                               dataset.cy, fps=dataset.fps,
                               bf=dataset.fx * getattr(dataset, "baseline", 0.2),
                               depth_threshold=20.0)
        try:  # resolve the preset so --features switches detectors
            tracker_cfg = dataclasses.replace(FeatureTrackerConfigs.get(args.features),
                                              num_features=args.num_features)
            if tracker_cfg.detector_type.name in ("ORB2", "FAST"):
                tracker_cfg = dataclasses.replace(tracker_cfg, num_levels=4)
        except KeyError:
            tracker_cfg = FeatureTrackerConfig(name=args.features,
                                               num_features=args.num_features, num_levels=4)
        loop_cfg = args.loop_detector

    if args.no_loop_closing:
        loop_cfg = None
    depth_estimator = None
    if args.depth_estimator and sensor == SensorType.MONOCULAR:
        if stereo_estimator and len(dataset) and dataset.getImageRight(0) is None:
            ap.error(f"--depth_estimator {args.depth_estimator} needs a stereo pair; the "
                     "monocular dataset gives no right image")
        # the MONOCULAR -> RGBD upgrade: each frame's depth estimated in
        # the front-end (the reference's main_slam.py)
        from pyslam_tpu_torch.depth_estimation.depth_estimator import depth_estimator_factory

        depth_estimator = depth_estimator_factory(args.depth_estimator, camera=camera,
                                                  device=device)

    slam = Slam(camera, tracker_cfg, loop_detector_config=loop_cfg, sensor_type=sensor,
                depth_estimator=depth_estimator, device=device)

    integrator = None
    if args.volumetric:
        from pyslam_tpu_torch.dense.volumetric_integrator import (
            VolumetricIntegratorType, volumetric_integrator_factory)

        if sensor == SensorType.STEREO or (args.depth_estimator and sensor != SensorType.RGBD):
            # no native dense depth: estimate it inside the integrator
            Parameters.kVolumetricIntegrationUseDepthEstimator = True
            if args.depth_estimator:
                Parameters.kVolumetricIntegrationDepthEstimatorType = args.depth_estimator
        integrator = volumetric_integrator_factory(
            VolumetricIntegratorType.TSDF, camera=camera,
            environment_type=dataset.environment_type, device=device)
        slam.set_volumetric_integrator(integrator)   # saved with the state
    semantic_mapping = None
    if args.semantics:
        from pyslam_tpu_torch.semantics.semantic_mapping import semantic_mapping_factory

        # local mapping hands it each keyframe and weights its BA by class
        # (kUseSemanticsInOptimization)
        semantic_mapping = semantic_mapping_factory(slam.map, device=device)
        slam.set_semantic_mapping(semantic_mapping)
    if args.load_state:
        slam.load_system_state(args.load_state)

    # ---------------------------------------------------------------- loop
    timer = TimerFps("frame")
    num_lost = 0
    lats: list[float] = []
    profile_ctx = None
    if args.profile:
        from pyslam_tpu_torch.utils.profiling import device_trace

        profile_ctx = device_trace(args.profile)
        profile_ctx.__enter__()
        Printer.cyan(f"profiling device trace -> {args.profile}")
    carry = None   # (i, img, img_right) read ahead for the pipelined loop
    t_start = None
    for i in range(len(dataset)):
        if carry is not None and carry[0] == i:
            img, img_right_i = carry[1], carry[2]
        else:
            img, img_right_i = dataset.getImage(i), dataset.getImageRight(i)
        if img is None:
            break
        depth = dataset.getDepth(i)
        # pipelined loop: hand the next stereo frame to track() so its
        # extraction is queued behind this frame's tracking
        nxt = None
        carry = None
        if i + 1 < len(dataset):
            n_img = dataset.getImage(i + 1)
            n_right = dataset.getImageRight(i + 1)
            carry = (i + 1, n_img, n_right)
            if n_img is not None and n_right is not None:
                nxt = {"img": n_img, "img_right": n_right, "frame_id": i + 1,
                       "timestamp": dataset.getTimestamp(i + 1)}
        if i == LATENCY_SKIP:
            t_start = time.perf_counter()
        with timer:
            slam.track(img, img_right=img_right_i, depth=depth, frame_id=i,
                       timestamp=dataset.getTimestamp(i), next_input=nxt)
        lats.append(timer.elapsed)
        if slam.state.name != "OK":
            num_lost += 1
        if i % 20 == 0:
            Printer.green(f"frame {i}/{len(dataset)}: state={slam.state.name} "
                          f"kfs={slam.map.num_keyframes()} pts={slam.map.num_points()} "
                          f"fps={timer.fps:.1f}")

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
        Printer.cyan(f"device trace saved: {args.profile}")

    # -------------------------------------------------------------- outputs
    ts, poses = slam.get_final_trajectory()   # drains the back-end first
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t_start if t_start is not None else 0.0
    if args.print_timings:
        Printer.cyan(slam.timings_summary())
    Printer.blue(f"done: {len(ts)} tracked frames, {slam.map.num_keyframes()} keyframes, "
                 f"{slam.map.num_points()} points, {num_lost} lost frames")
    if slam.loop_closing is not None:
        Printer.blue(f"loops closed: {slam.loop_closing.num_loops_closed}")

    if args.save_trajectory:
        with TrajectoryWriter(args.trajectory_format, args.save_trajectory) as tw:
            tw.write_full_trajectory(ts, poses)
        Printer.green(f"trajectory -> {args.save_trajectory}")

    lat_ms = np.asarray(lats[LATENCY_SKIP:] or lats) * 1e3
    metrics = {"num_frames": len(dataset), "num_tracked": len(ts), "num_lost": num_lost,
               "fps": timer.fps,
               "fps_from_frame_10": ((len(lats) - LATENCY_SKIP) / wall) if wall > 0 else None,
               "frame_ms_p50": float(np.percentile(lat_ms, 50)) if len(lat_ms) else None,
               "frame_ms_p95": float(np.percentile(lat_ms, 95)) if len(lat_ms) else None,
               "num_keyframes": slam.map.num_keyframes(), "num_points": slam.map.num_points(),
               "loops_closed": (slam.loop_closing.num_loops_closed
                                if slam.loop_closing is not None else 0),
               "volumetric_keyframes": len(integrator.snapshots) if integrator else 0,
               "volumetric_integrated": integrator.volume.num_integrated if integrator else 0,
               "semantic_keyframes": sum(getattr(kf, "kps_sem", None) is not None
                                         for kf in slam.map.keyframes.values()),
               "semantic_points": (len(semantic_mapping.point_scores)
                                   if semantic_mapping is not None else 0),
               "stage_totals_ms": {mod: {k: v["total_ms"] for k, v in st.items()}
                                   for mod, st in slam.timings().items()}}
    if gt is not None and len(ts) > 3:
        res = eval_ate(ts, poses[:, :3, 3], gt.timestamps, gt.positions,
                       with_scale=(sensor == SensorType.MONOCULAR))
        Printer.blue(str(res))
        metrics["ate_rmse"] = res.rmse
        metrics["ate_max"] = res.max
    Printer.blue("metrics: " + json.dumps({k: v for k, v in metrics.items()
                                           if k != "stage_totals_ms"}))

    if args.save_state:
        slam.save_system_state(args.save_state)
        with open(os.path.join(args.save_state, "other_metrics_info.txt"), "w") as f:
            json.dump(metrics, f, indent=2)
    if integrator is not None:
        pts, _ = integrator.get_point_cloud()
        Printer.blue(f"dense map: {len(pts)} surface voxels")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
