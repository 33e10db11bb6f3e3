"""bench.py's loop stage on the CPU, in the JAX package or in the port.

    python -m tests.torch_loop_stage [--package jax|port] [--frames 150] [--trace]
                                     [--loop DBOW3|COSPLACE|VLAD|...] [--candidates]

Runs chip_smoke.py's phase 8 configuration (bench.py:193-267: 150 frames of
the 376x1241 stereo circle, period 130, a 16000-point world of extent 30 m,
2000 ORB2 features on 8 levels, depth threshold 35, the DBOW3 detector, or
the ``--loop`` detector: COSPLACE for phase 14c, VLAD for 16d) one frame at a time with
next-frame prefetch, the JAX package with x64 off as it runs outside the
tests.  Prints each frame whose tracking fails or that is
relocalised, each loop closure with the ATE of the trajectory so far just
before and after its correction, and at the end the frames tracked, loops
closed, GBAs applied and the final ATE.  With ``--trace`` it also prints,
from the loop closure on, each local BA applied: the largest keyframe
translation it made and the observations before and after it.  With
``--candidates`` it prints, for each keyframe the detector queries, its
connected keyframes, the candidates the database proposes and the five
stored keyframes of highest global-descriptor similarity, the consistent
candidates and each geometry check's outcome (phase 16d's VLAD: the most
similar stored keyframes score 0.18-0.28 over 125 frames, no higher than
the covisible neighbours).  A witness
for the port's phases 8, 14c and 16d: it tells a property of the reference from a fault
of the port.
"""

import argparse
import time

import numpy as np

import chip_smoke


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--frames", type=int, default=chip_smoke.LOOP_FRAMES)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--loop", default="DBOW3")
    ap.add_argument("--candidates", action="store_true")
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
        kw = {"device": "cpu"}
    ds = chip_smoke.loop_stream()
    n = args.frames
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
    gt_p = ds.poses[:n, :3, 3]
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=35.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=chip_smoke.N_FEATURES,
                                          num_levels=chip_smoke.N_LEVELS),
                loop_detector_config=args.loop, sensor_type=SensorType.STEREO, **kw)
    lc = slam.loop_closing

    def ate():
        ts, Twc = slam.tracking.history.final_trajectory(slam.map)
        return float(eval_ate(ts, Twc[:, :3, 3], gt_t, gt_p, align=True,
                              with_scale=False).rmse)

    correct = lc.correct_loop

    def correct_loop(kf, cand, S12):
        before = ate()
        correct(kf, cand, S12)
        print(f"frame {i}: loop kf {kf.kid} <-> kf {cand.kid}, ATE so far {before:.4f} m "
              f"before the correction, {ate():.4f} m after", flush=True)

    lc.correct_loop = correct_loop
    lm = slam.local_mapping
    lba_apply = lm._lba_apply

    def traced_lba_apply(lba, *res):
        m = slam.map
        before = {k: m.keyframes[k].Tcw[:3, 3].copy() for k in lba["all_kids"]
                  if k in m.keyframes}
        n_obs = sum(len(o) for o in m.observations.values())
        lba_apply(lba, *res)
        moved = max((np.abs(m.keyframes[k].Tcw[:3, 3] - t).max()
                     for k, t in before.items() if k in m.keyframes), default=0.0)
        if lc.num_loops_closed:
            print(f"frame {i}: local BA of kf {lba['all_kids'][0]} applied, largest keyframe "
                  f"move {moved:.3f} m, observations {n_obs} -> "
                  f"{sum(len(o) for o in m.observations.values())}", flush=True)

    if args.trace:
        lm._lba_apply = traced_lba_apply
    if args.candidates:
        trace_candidates(lc)
    t0 = time.perf_counter()
    frame = lambda j: (ds.getImage(j), ds.getImageRight(j), ds.getTimestamp(j))  # noqa: E731
    cur = frame(0)
    for i in range(n):
        nxt = frame(i + 1) if i + 1 < n else None
        n_hist = len(slam.tracking.history.timestamps)
        slam.track(cur[0], img_right=cur[1], frame_id=i, timestamp=cur[2],
                   next_input=None if nxt is None else {
                       "img": nxt[0], "img_right": nxt[1], "frame_id": i + 1,
                       "timestamp": nxt[2]})
        if len(slam.tracking.history.timestamps) == n_hist:
            print(f"frame {i}: not tracked ({slam.tracking.state.name})", flush=True)
        if i % 25 == 0:
            print(f"frame {i}: {slam.map.num_keyframes()} keyframes, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
        cur = nxt
    slam.finish()
    print(f"{args.package} loop={args.loop}: {len(slam.tracking.history.timestamps)}/{n} tracked, "
          f"{lc.num_loops_closed} loops closed, {slam.GBA.runs_completed} GBA applied, "
          f"{slam.map.num_keyframes()} keyframes, ATE {ate():.4f} m "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)


def trace_candidates(lc):
    """Wrap the loop closer's database query, consistency check and
    geometry check of either package to print what each returns."""
    detect, check, geometry = (lc.db.detect_loop_candidates, lc.consistency.check,
                               lc.geometry_check)

    def detect_loop_candidates(kid, words, g_des, connected, covisibles_of, *a, **kw):
        out = detect(kid, words, g_des, connected, covisibles_of, *a, **kw)
        sims = sorted(((float(np.dot(g_des, g)), c) for c, g in lc.db.kf_gdes.items()),
                      reverse=True)[:5]
        print(f"kf {kid}: connected {sorted(connected)} candidates {out} most similar "
              f"{[(c, round(v, 3)) for v, c in sims]}", flush=True)
        return out

    def consistency_check(candidates, group_of):
        out = check(candidates, group_of)
        if candidates:
            print(f"  consistent {out} of {candidates}", flush=True)
        return out

    def geometry_check(kf, cand):
        res = geometry(kf, cand)
        print(f"  geometry kf {kf.kid} with kf {cand.kid}: ok {res[0]}, {res[2]} matches",
              flush=True)
        return res

    lc.db.detect_loop_candidates = detect_loop_candidates
    lc.consistency.check = consistency_check
    lc.geometry_check = geometry_check


if __name__ == "__main__":
    main()
