"""The monocular loop of tests/test_loop_e2e_mono.py, traced, in the JAX
package or in the port.

    python -m tests.torch_mono_loop [--package jax|port] [--min-frames-between-kfs N]

Runs that test's configuration (175 frames of a 240x320 circle with a
revisit tail, period 160, 800 ORB2 features on 4 levels, the DBOW3
detector) on the CPU, the JAX package with x64 off as it runs outside the
tests, and prints every 20 frames the keyframes and the ATE so far after a
similarity alignment (with its scale), each frame not tracked, each loop
correction with the scale of its Sim(3) and the ATE just before and after
it, and the final ATE.  ``--min-frames-between-kfs`` sets
``kNumMinFramesBetweenKfs`` (0, the default, as the reference).  A witness
for the monocular drift: whether a floor the port misses is missed by the
reference too.
"""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--min-frames-between-kfs", type=int, default=0)
    args = ap.parse_args()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from pyslam_tpu.config_parameters import Parameters
        from pyslam_tpu.evaluation.metrics import eval_ate
        from pyslam_tpu.features.tracker import FeatureTrackerConfig
        from pyslam_tpu.io.dataset import SyntheticDataset
        from pyslam_tpu.io.dataset_types import SensorType
        from pyslam_tpu.slam.camera import PinholeCamera
        from pyslam_tpu.slam.slam import Slam
        kw = {}
    else:
        from pyslam_tpu_torch.config_parameters import Parameters
        from pyslam_tpu_torch.evaluation.metrics import eval_ate
        from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
        from pyslam_tpu_torch.io.dataset_types import SensorType
        from pyslam_tpu_torch.io.synthetic import SyntheticDataset
        from pyslam_tpu_torch.slam.camera import PinholeCamera
        from pyslam_tpu_torch.slam.slam import Slam
        kw = {"device": "cpu"}
    Parameters.kNumMinFramesBetweenKfs = args.min_frames_between_kfs
    ds = SyntheticDataset(num_frames=175, period=160, sensor_type=SensorType.MONOCULAR,
                          trajectory="loop")
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=0.0,
                        depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=800, num_levels=4),
                loop_detector_config="DBOW3", sensor_type=SensorType.MONOCULAR, **kw)
    gt_t = np.array([ds.getTimestamp(i) for i in range(len(ds))])

    def ate():
        ts, T = slam.tracking.history.final_trajectory(slam.map)
        if len(ts) < 3:
            return None
        return eval_ate(ts, T[:, :3, 3], gt_t, ds.poses[:, :3, 3], with_scale=True)

    lc = slam.loop_closing
    correct = lc.correct_loop

    def correct_loop(kf, cand, S12):
        before = ate()
        correct(kf, cand, S12)
        after = ate()
        print(f"frame {i}: loop kf {kf.kid} <-> kf {cand.kid}, Sim(3) scale "
              f"{np.cbrt(np.linalg.det(np.asarray(S12)[:3, :3])):.4f}; ATE {before.rmse:.3f} m "
              f"-> {after.rmse:.3f} m", flush=True)

    lc.correct_loop = correct_loop
    for i in range(len(ds)):
        n = len(slam.tracking.history.timestamps)
        slam.track(ds.getImage(i), frame_id=i, timestamp=ds.getTimestamp(i))
        if len(slam.tracking.history.timestamps) == n:
            print(f"frame {i}: not tracked ({slam.tracking.state.name})", flush=True)
        if i % 20 == 0:
            a = ate()
            print(f"frame {i}: {slam.map.num_keyframes()} keyframes, ATE "
                  + ("-" if a is None else f"{a.rmse:.3f} m (scale {a.scale:.2f})"), flush=True)
    slam.finish()
    ts, _ = slam.get_final_trajectory()
    a = ate()
    print(f"{args.package}: {lc.num_loops_closed} loops closed, {len(ts)}/{len(ds)} tracked, "
          f"{slam.map.num_keyframes()} keyframes, ATE {a.rmse:.4f} m", flush=True)


if __name__ == "__main__":
    main()
