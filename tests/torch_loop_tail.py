"""chip_smoke.py's phase 8 (bench.py's loop stage) run several times on the
card, to measure the spread of its outcome.

    PYTHONPATH=. python3 tests/torch_loop_tail.py [BUDGETS] [--out FILE]

BUDGETS is a comma-separated list of local mapping host budgets in ms
(``Parameters.kLocalMappingHostBudgetMs``, 8 by default), one run each;
a smaller budget stands in for a slower host.  Each run prints one JSON
line (loops closed, frames in the final trajectory, ATE before and after
the final drain, the GBA's cost, the keyframes' aligned position error,
the trajectory error by ten-frame bin) and below it the events: each
geometry check with at least 5 RANSAC inliers, the correction (ATE of the
trajectory so far and the keyframes' error before and after it, the loop
connections that the fusion made, the points the correction moved), the
GBA's dispatch and each of its chunks (its cost), its write-back and every
local BA applied while a GBA runs or after it.  The lines also go to FILE
(``loop_tail.log`` by default).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs


def main():
    import torch

    from pyslam_tpu_torch import _build
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.evaluation.metrics import umeyama_np
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    args = sys.argv[1:]
    out = "loop_tail.log"
    if "--out" in args:
        out = args[args.index("--out") + 1]
        del args[args.index("--out"):args.index("--out") + 2]
    budgets = [float(b) for b in (args[0] if args else "8").split(",")]
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    logf = open(out, "w")

    def emit(line):
        print(line, flush=True)
        print(line, file=logf, flush=True)

    emit(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                        capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    _build.load()
    frames = cs.render(cs.render_loop_frames, cs.LOOP_FRAMES)
    ds = cs.loop_stream()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(cs.LOOP_FRAMES)])
    gt_p = ds.poses[:cs.LOOP_FRAMES, :3, 3]
    budget0 = Parameters.kLocalMappingHostBudgetMs
    for run, budget in enumerate(budgets):
        Parameters.kLocalMappingHostBudgetMs = budget
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            bf=ds.fx * ds.baseline, depth_threshold=35.0)
        slam = Slam(cam, FeatureTrackerConfig(num_features=cs.N_FEATURES,
                                              num_levels=cs.N_LEVELS),
                    loop_detector_config="DBOW3", sensor_type=SensorType.STEREO, device=dev)
        lc, lm, gba = slam.loop_closing, slam.local_mapping, slam.loop_closing.gba
        cur = {"i": -1}
        ev = []

        def ate():
            return round(cs.ate_of(slam, gt_t, gt_p), 4)

        def kf_err():
            """Aligned keyframe position error: rmse and the 3 worst
            (keyframe id, frame, metres)."""
            kfs = [slam.map.keyframes[k] for k in slam.map.keyframe_order]
            a = np.stack([k.Twc[:3, 3] for k in kfs])
            b = gt_p[[k.id for k in kfs]]
            _, rot, t = umeyama_np(a, b, False)
            e = np.linalg.norm(a @ rot.T + t - b, axis=1)
            return {"rmse": round(float(np.sqrt((e ** 2).mean())), 3),
                    "worst": [(kfs[j].kid, kfs[j].id, round(float(e[j]), 2))
                              for j in np.argsort(-e)[:3]]}

        geometry_check = lc.geometry_check

        def traced_geometry_check(kf, cand):
            res = geometry_check(kf, cand)
            if lc.last_geometry.get("ransac_inliers", 0) >= 5:
                ev.append(("geometry", cur["i"], kf.kid, cand.kid, bool(res[0]),
                           dict(lc.last_geometry)))
            return res

        correct_loop = lc.correct_loop

        def traced_correct_loop(kf, cand, S12):
            before = (ate(), kf_err())
            correct_loop(kf, cand, S12)
            ev.append(("correct", cur["i"], kf.kid, cand.kid, before, (ate(), kf_err()),
                       lc.last_pgo_size))

        pgo = lc._essential_graph_pgo

        def traced_pgo(*args):
            # (kf, cand, S_old, corrected[, loop connections, corrected_by])
            ev.append(("loop_connections", len(args[4]) if len(args) > 4 else None,
                       "points_moved", len(args[5]) if len(args) > 5 else None))
            return pgo(*args)

        dispatch = gba.dispatch

        def traced_dispatch(m, iters=None):
            dispatch(m, iters)
            st = gba._state
            ev.append(("gba_dispatch", cur["i"], len(st["kids"]) if st else 0,
                       len(st["pids"]) if st else 0))

        poll = gba.poll

        def traced_poll(block=False):
            st = gba._state
            if st is not None and (block or st["pending"].ready()):
                ev.append(("gba_chunk", cur["i"], float(st["pending"].value[2]),
                           st["iters_left"]))
            return poll(block)

        apply_gba = gba._apply

        def traced_apply_gba(st, *a):
            before = (ate(), kf_err())
            apply_gba(st, *a)
            ev.append(("gba_apply", cur["i"], before, (ate(), kf_err())))

        apply_lba = lm._lba_apply

        def traced_apply_lba(lba, *a):
            before = ate()
            apply_lba(lba, *a)
            if gba.runs_completed or gba.running:
                ev.append(("lba_apply", cur["i"], before, ate(), len(lba["kid_to_row"])))

        lc.geometry_check = traced_geometry_check
        lc.correct_loop = traced_correct_loop
        lc._essential_graph_pgo = traced_pgo
        gba.dispatch, gba.poll, gba._apply = traced_dispatch, traced_poll, traced_apply_gba
        lm._lba_apply = traced_apply_lba
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (img_l, img_r, ts) in enumerate(frames):
            cur["i"] = i
            nxt = None
            if i + 1 < cs.LOOP_FRAMES:
                nl, nr, nts = frames[i + 1]
                nxt = {"img": nl, "img_right": nr, "frame_id": i + 1, "timestamp": nts}
            slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts, next_input=nxt)
        cur["i"] = "finish"
        ate_drain = ate()
        slam.finish()
        torch.cuda.synchronize()
        ts_est, twc = slam.tracking.history.final_trajectory(slam.map)
        idx = np.asarray([int(np.argmin(np.abs(gt_t - t))) for t in ts_est])
        _, rot, t = umeyama_np(twc[:, :3, 3], gt_p[idx], False)
        err = np.linalg.norm(twc[:, :3, 3] @ rot.T + t - gt_p[idx], axis=1)
        bins = {int(b): round(float(err[(idx >= b) & (idx < b + 10)].mean()), 3)
                for b in range(0, cs.LOOP_FRAMES, 10) if ((idx >= b) & (idx < b + 10)).any()}
        emit(json.dumps({"run": run, "budget_ms": budget, "loops": lc.num_loops_closed,
                         "in_trajectory": len(ts_est), "keyframes": slam.map.num_keyframes(),
                         "ate_before_drain": ate_drain, "ate": ate(),
                         "gba_applied": gba.runs_completed, "gba_cost": gba.last_cost,
                         "kf_err": kf_err(), "wall_s": round(time.perf_counter() - t0, 1),
                         "err_by_10_frames": bins}))
        for e in ev:
            emit("   " + json.dumps(e, default=str))
        del slam
        torch.cuda.empty_cache()
    Parameters.kLocalMappingHostBudgetMs = budget0


if __name__ == "__main__":
    main()
