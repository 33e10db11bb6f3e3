"""chip_smoke.py's RGBD, monocular or stereo stage, or its monocular visual
odometry, in the JAX package (on the CPU) or in the port.

    python -m tests.torch_sensor_stage [--package jax|port]
                                       [--sensor mono|rgbd|stereo|vo]
                                       [--preset ORB2] [--loop DBOW3_INDEPENDENT]
                                       [--frames 60] [--device cpu|cuda]
                                       [--depth-estimator sgbm|depth_anything_v2|mast3r|...]
                                       [--polls-like-the-port] [--log-kf]
                                       [--reference-pyramid]

Runs the configuration of chip_smoke.py phases 9, 10 and 12: the main
stage's 376x1241 stream (fx 718.856, a 16000-point world at depth 4-80 m, a
straight line at 0.8 m a frame), depth threshold 35, bf = fx * 0.54 (the
stereo baseline, and the RGBD virtual right coordinates), no integrator,
one frame at a time; the JAX package with x64 off as it runs outside the
tests, the port on ``--device`` (the CPU by default).  The tracker is
``--preset`` at its own width (ORB2: 2000 features on 8 levels), with the
``--loop`` detector if one is named (none by default).  Prints each frame
not tracked, each reset, the frame at which the map was initialised, and at
the end the frames tracked, the resets, the keyframes and the ATE (after a
similarity alignment for the monocular sensor).  ``--sensor vo`` runs
``VisualOdometry`` with the preset's tracker on the monocular stream (the
ground truth's scale, as phase 11) and prints its frames, matches of the
last frame and ATE.  The witness that sets phase 10's initialisation
margin, phase 12's and 14a's tracked frames and ATE ceilings and 14b's ATE
ceiling.

``--depth-estimator TYPE`` with ``--sensor mono`` is phase 17b's and 17c's
configuration: ``Slam(sensor_type=MONOCULAR, depth_estimator=...)`` (the
factory's defaults; the JAX package's ``PRNGKey(0)`` weights, the port's
seeded ones), upgraded to RGBD.  A stereo estimator (``sgbm``) takes the
stream's right image, which ``track()`` also hands to the frame, as in
both packages; a monocular one gets the left image only.  The ATE is
metric (no scale in the alignment), and the trajectory's length is
printed beside the ground truth's.  The witness of phase 17b's ATE ceiling
and of 17c's reference numbers.

``--polls-like-the-port`` runs the JAX package under
``tests.torch_parity.reference_polls_like_the_port``: its back-end results
ready by the port's CPU rule (``local_mapping.Pending``), not by
``jax.Array.is_ready`` under the host's load, so that both packages'
keyframe cadences follow one schedule.  ``--log-kf`` sets
``kLogKeyFrameDecision`` in the package it runs, so that every frame prints
its ``[kf?]`` line, and prints the frames that made a keyframe at the end.
``--reference-pyramid`` hands the port's ORB2 extractor the JAX package's
image pyramid for every image
(``tests.torch_parity.port_extracts_from_the_reference_pyramid``): the
port's pyramid column pass keeps one FMA chain, within 3.05e-5 grey levels
of the reference's, which this takes out of the comparison.
"""

import argparse
import contextlib
import time

import numpy as np

import chip_smoke


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--sensor", choices=("mono", "rgbd", "stereo", "vo"), default="mono")
    ap.add_argument("--preset", default="ORB2")
    ap.add_argument("--loop", default=None)
    ap.add_argument("--frames", type=int, default=chip_smoke.N_FRAMES)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--depth-estimator", default=None)
    ap.add_argument("--polls-like-the-port", action="store_true")
    ap.add_argument("--log-kf", action="store_true")
    ap.add_argument("--reference-pyramid", action="store_true")
    args = ap.parse_args()
    patched = contextlib.nullcontext()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from pyslam_tpu.config_parameters import Parameters
        from pyslam_tpu.depth_estimation.depth_estimator import depth_estimator_factory
        from pyslam_tpu.evaluation.metrics import eval_ate
        from pyslam_tpu.features.tracker import FeatureTrackerConfig, feature_tracker_factory
        from pyslam_tpu.io.dataset_types import SensorType
        from pyslam_tpu.io.ground_truth import groundtruth_factory
        from pyslam_tpu.slam.camera import PinholeCamera
        from pyslam_tpu.slam.slam import Slam
        from pyslam_tpu.slam.visual_odometry import VisualOdometry
        kw = {}
        assert not args.reference_pyramid, "--reference-pyramid is for the port"
        if args.polls_like_the_port:
            from tests.torch_parity import reference_polls_like_the_port

            patched = reference_polls_like_the_port()
    else:
        from pyslam_tpu_torch.config_parameters import Parameters
        from pyslam_tpu_torch.depth_estimation.depth_estimator import depth_estimator_factory
        from pyslam_tpu_torch.evaluation.metrics import eval_ate
        from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
        from pyslam_tpu_torch.io.dataset_types import SensorType
        from pyslam_tpu_torch.io.ground_truth import groundtruth_factory
        from pyslam_tpu_torch.slam.camera import PinholeCamera
        from pyslam_tpu_torch.slam.slam import Slam
        from pyslam_tpu_torch.slam.visual_odometry import VisualOdometry
        kw = {"device": args.device}
        assert not args.polls_like_the_port, "--polls-like-the-port is for the JAX package"
        if args.reference_pyramid:
            from tests.torch_parity import port_extracts_from_the_reference_pyramid

            patched = port_extracts_from_the_reference_pyramid()
    Parameters.kLogKeyFrameDecision = args.log_kf
    if args.sensor == "vo":
        # phase 11's stream: the RGBD rendering's left images, mono camera
        ds = chip_smoke.bench_stream("RGBD")
        n = args.frames
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            depth_threshold=35.0)
        gt = groundtruth_factory({"type": "synthetic", "dataset": ds})
        vo = VisualOdometry(cam, feature_tracker_factory(args.preset, **kw), groundtruth=gt)
        t0 = time.perf_counter()
        for i in range(n):
            vo.track(ds.getImage(i), i, ds.getTimestamp(i))
            if i % 10 == 0:
                print(f"frame {i}: {vo.num_matches} matches, {vo.num_inliers} inliers, "
                      f"{time.perf_counter() - t0:.0f} s", flush=True)
        ate = float(eval_ate(np.asarray(vo.timestamps), vo.trajectory, gt.timestamps,
                             gt.positions[:n], align=True, with_scale=False).rmse)
        print(f"{args.package} vo {args.preset}: {len(vo.timestamps)}/{n} frames, "
              f"{vo.num_matches} matches on the last, ATE {ate:.4f} m "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
        return
    mono = args.sensor == "mono"
    sensor = {"mono": "MONOCULAR", "rgbd": "RGBD", "stereo": "STEREO"}[args.sensor]
    stereo_estimator = args.depth_estimator in ("sgbm", "raft_stereo", "crestereo")
    ds = chip_smoke.bench_stream("STEREO" if stereo_estimator else sensor)
    n = args.frames
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * chip_smoke.BASELINE_M, depth_threshold=35.0)
    tracker = (FeatureTrackerConfig(num_features=chip_smoke.N_FEATURES,
                                    num_levels=chip_smoke.N_LEVELS)
               if args.preset == "ORB2" else args.preset)
    est = None
    if args.depth_estimator:
        assert mono, "--depth-estimator upgrades a monocular session"
        est = depth_estimator_factory(args.depth_estimator, camera=cam, **kw)
        mono = False          # an RGBD session: metric, no scale in the ATE
    slam = Slam(cam, tracker, loop_detector_config=args.loop, sensor_type=SensorType[sensor],
                depth_estimator=est, **kw)
    resets = []
    reset = slam.reset

    def counted_reset():
        resets.append(i)
        print(f"frame {i}: reset", flush=True)
        reset()

    slam.reset = counted_reset
    with patched:
        t0 = time.perf_counter()
        init_frame = None
        kf_frames = []
        for i in range(n):
            n_hist = len(slam.tracking.history.timestamps)
            slam.track(ds.getImage(i),
                       img_right=ds.getImageRight(i) if sensor == "STEREO" or stereo_estimator
                       else None,
                       depth=ds.getDepth(i) if sensor == "RGBD" else None, frame_id=i,
                       timestamp=ds.getTimestamp(i))
            if len(slam.tracking.history.timestamps) == n_hist:
                print(f"frame {i}: not tracked ({slam.tracking.state.name})", flush=True)
            elif init_frame is None:
                init_frame = i
                print(f"frame {i}: map initialised, {slam.map.num_keyframes()} keyframes, "
                      f"{slam.map.num_points()} points", flush=True)
            kf = slam.tracking.kf_ref
            if kf is not None and kf.id == i:
                kf_frames.append(i)
            if i % 10 == 0:
                print(f"frame {i}: {slam.map.num_keyframes()} keyframes, "
                      f"{time.perf_counter() - t0:.0f} s", flush=True)
        slam.finish()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
    ts, Twc = slam.tracking.history.final_trajectory(slam.map)
    ate = (float(eval_ate(ts, Twc[:, :3, 3], gt_t, ds.poses[:n, :3, 3], align=True,
                          with_scale=mono).rmse) if len(ts) >= 3 else float("nan"))
    length = ""
    if len(ts) >= 2:
        est_len = np.linalg.norm(np.diff(Twc[:, :3, 3], axis=0), axis=1).sum()
        gt_len = np.linalg.norm(np.diff(ds.poses[:n, :3, 3], axis=0), axis=1).sum()
        length = f", trajectory {est_len:.3f} m against {gt_len:.3f} m"
    print(f"{args.package} {args.sensor} {args.preset} loop={args.loop} "
          f"depth_estimator={args.depth_estimator} ({slam.sensor_type.name}): initialised at "
          f"frame {init_frame}, {len(slam.tracking.history.timestamps)}/{n} tracked, "
          f"{len(resets)} resets, {slam.map.num_keyframes()} keyframes, ATE {ate:.4f} m"
          f"{length} ({time.perf_counter() - t0:.0f} s)", flush=True)
    if args.log_kf:
        print(f"keyframes made at frames {kf_frames}", flush=True)


if __name__ == "__main__":
    main()
