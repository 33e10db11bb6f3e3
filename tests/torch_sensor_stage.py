"""chip_smoke.py's RGBD, monocular or stereo stage, in the JAX package (on
the CPU) or in the port.

    python -m tests.torch_sensor_stage [--package jax|port]
                                       [--sensor mono|rgbd|stereo]
                                       [--preset ORB2] [--loop DBOW3_INDEPENDENT]
                                       [--frames 60] [--device cpu|cuda]

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
similarity alignment for the monocular sensor).  The witness that sets
phase 10's initialisation margin and phase 12's tracked frames and ATE
ceilings.
"""

import argparse
import time

import numpy as np

import chip_smoke


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--sensor", choices=("mono", "rgbd", "stereo"), default="mono")
    ap.add_argument("--preset", default="ORB2")
    ap.add_argument("--loop", default=None)
    ap.add_argument("--frames", type=int, default=chip_smoke.N_FRAMES)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from pyslam_tpu.evaluation.metrics import eval_ate
        from pyslam_tpu.features.tracker import FeatureTrackerConfig
        from pyslam_tpu.io.dataset_types import SensorType
        from pyslam_tpu.slam.camera import PinholeCamera
        from pyslam_tpu.slam.slam import Slam
        kw = {}
    else:
        from pyslam_tpu_torch.evaluation.metrics import eval_ate
        from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
        from pyslam_tpu_torch.io.dataset_types import SensorType
        from pyslam_tpu_torch.slam.camera import PinholeCamera
        from pyslam_tpu_torch.slam.slam import Slam
        kw = {"device": args.device}
    mono = args.sensor == "mono"
    sensor = {"mono": "MONOCULAR", "rgbd": "RGBD", "stereo": "STEREO"}[args.sensor]
    ds = chip_smoke.bench_stream(sensor)
    n = args.frames
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * chip_smoke.BASELINE_M, depth_threshold=35.0)
    tracker = (FeatureTrackerConfig(num_features=chip_smoke.N_FEATURES,
                                    num_levels=chip_smoke.N_LEVELS)
               if args.preset == "ORB2" else args.preset)
    slam = Slam(cam, tracker, loop_detector_config=args.loop, sensor_type=SensorType[sensor],
                **kw)
    resets = []
    reset = slam.reset

    def counted_reset():
        resets.append(i)
        print(f"frame {i}: reset", flush=True)
        reset()

    slam.reset = counted_reset
    t0 = time.perf_counter()
    init_frame = None
    for i in range(n):
        n_hist = len(slam.tracking.history.timestamps)
        slam.track(ds.getImage(i),
                   img_right=ds.getImageRight(i) if sensor == "STEREO" else None,
                   depth=ds.getDepth(i) if sensor == "RGBD" else None, frame_id=i,
                   timestamp=ds.getTimestamp(i))
        if len(slam.tracking.history.timestamps) == n_hist:
            print(f"frame {i}: not tracked ({slam.tracking.state.name})", flush=True)
        elif init_frame is None:
            init_frame = i
            print(f"frame {i}: map initialised, {slam.map.num_keyframes()} keyframes, "
                  f"{slam.map.num_points()} points", flush=True)
        if i % 10 == 0:
            print(f"frame {i}: {slam.map.num_keyframes()} keyframes, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    slam.finish()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
    ts, Twc = slam.tracking.history.final_trajectory(slam.map)
    ate = (float(eval_ate(ts, Twc[:, :3, 3], gt_t, ds.poses[:n, :3, 3], align=True,
                          with_scale=mono).rmse) if len(ts) >= 3 else float("nan"))
    print(f"{args.package} {args.sensor} {args.preset} loop={args.loop}: initialised at frame "
          f"{init_frame}, {len(slam.tracking.history.timestamps)}/{n} tracked, "
          f"{len(resets)} resets, {slam.map.num_keyframes()} keyframes, ATE {ate:.4f} m "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
