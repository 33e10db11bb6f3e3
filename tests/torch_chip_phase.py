"""One phase of chip_smoke.py on the card, alone: 8 (bench.py's loop stage),
12 (the weight-free feature presets), 13 (main_slam on a KITTI sequence
written to disk, then the saved state reloaded), 14 (the learned models:
the SuperPoint session, the LightGlue VO and the COSPLACE loop stage) or 15
(the learned local features: each model card against CPU and its times,
the learned presets' stereo sessions and the XFEAT_LIGHTGLUE VO) or 16
(LoFTR, MASt3R / DUSt3R and the MAST3R session, the other loop detectors
card against CPU, and the VLAD loop stage; ``16abc`` leaves the loop stage
out) or 17 (the depth models card against CPU, the SGBM upgrade of a
monocular session with the TSDF and the learned upgrades; ``17a`` the
models alone) or 18 (the semantic models card against CPU, the weight-free
semantic session with its floor and integrate_semantic card against CPU,
the learned segmenters' sessions; ``18a`` the models alone) or 19 (VGGT
and Fast3R card against CPU, main_scene_from_views and every scene-from-
views backend, the Gaussian-splatting session, main_map_dense_reconstruction;
``19a`` the two models alone) or 20 (the three trainers card against CPU,
trained and held to their floors; the large-window BA session, the ROS 2
bag session and the viewers' export; ``20a`` the trainers alone) or 21
(phase 13, whose saved state it reads, then the native mirror, the sharded
GBA, the evaluation grid and frontend_step).

    PYTHONPATH=. python3 tests/torch_chip_phase.py 8|12|...|19|19a|20|20a|21 [--log-kf]
    PYTHONPATH=. python3 tests/torch_chip_phase.py 13 --keep-state DIR

Builds the kernels, renders the phase's frames as chip_smoke.py does and
runs its function for the phase; prints what the phase prints.  Run from
the root of a tree (the repository, or an unpacked ``git archive`` of
another commit, to compare two commits in one call on one card).
``--log-kf`` sets the port's ``kLogKeyFrameDecision``, so that every
session of the phase prints each frame's ``[kf?]`` keyframe decision;
``--keep-state DIR`` copies phase 13's saved state to DIR (its
``map.json`` is what ``tests/torch_gba_placement.py --map`` reads).
"""

import json
import os
import subprocess
import sys
import time

import chip_smoke as cs


def main():
    import torch

    from pyslam_tpu_torch import _build
    from pyslam_tpu_torch.slam.camera import PinholeCamera

    arg = sys.argv[1]
    if "--log-kf" in sys.argv[2:]:
        from pyslam_tpu_torch.config_parameters import Parameters

        Parameters.kLogKeyFrameDecision = True
    phase = int(arg[:2]) if arg[:2] in ("16", "17", "18", "19", "20", "21") else int(arg)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.load()
    ds = cs.bench_stream()
    t0 = time.time()
    if phase == 8:
        frames = cs.render(cs.render_loop_frames, cs.LOOP_FRAMES)
        cs.loop_phase(dev, (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy), frames)
    elif phase == 13:
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
                  for i in range(cs.N_FRAMES)]
        t0 = time.time()
        keep = (sys.argv[sys.argv.index("--keep-state") + 1] if "--keep-state" in sys.argv
                else None)
        print(json.dumps({"entry": cs.entry_phase(dev, frames, ds, keep_state=keep)},
                         default=float), flush=True)
    elif phase == 12:
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            bf=ds.fx * ds.baseline, depth_threshold=35.0)
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
                  for i in range(cs.N_FRAMES)]
        t0 = time.time()
        print(json.dumps({"features": cs.features_phase(dev, frames[:cs.PRESET_FRAMES], cam,
                                                        ds)}, default=float), flush=True)
    elif phase == 14:
        from pyslam_tpu_torch.config_parameters import Parameters

        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            bf=ds.fx * ds.baseline, depth_threshold=35.0)
        cam_mono = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                                 depth_threshold=35.0)
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
                  for i in range(cs.N_FRAMES)]
        rgbd_frames = cs.render(cs.render_rgbd_frames, cs.N_FRAMES)
        loop_frames = cs.render(cs.render_loop_frames, cs.LOOP_FRAMES)
        t0 = time.time()
        models = {"superpoint": cs.superpoint_phase(dev, frames, cam, ds),
                  "lightglue_vo": cs.lightglue_vo_phase(dev, rgbd_frames, cam_mono,
                                                        cs.bench_stream("RGBD"))}
        retain = Parameters.kRetainImageForVPR
        try:
            models["cosplace"] = cs.loop_phase(dev, (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy),
                                               loop_frames, loop="COSPLACE")
        finally:
            Parameters.kRetainImageForVPR = retain
        print(json.dumps({"models": models}, default=float), flush=True)
    elif phase == 15:
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            bf=ds.fx * ds.baseline, depth_threshold=35.0)
        cam_mono = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                                 depth_threshold=35.0)
        n = cs.LEARNED_FRAMES
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i)) for i in range(n)]
        rgbd_frames = cs.render(cs.render_rgbd_frames, n)
        t0 = time.time()
        learned = {"models": cs.learned_models_phase(dev, frames),
                   "sessions": cs.learned_sessions_phase(dev, frames, cam, ds),
                   "xfeat_lightglue_vo": cs.lightglue_vo_phase(
                       dev, rgbd_frames, cam_mono, cs.bench_stream("RGBD"),
                       preset="XFEAT_LIGHTGLUE")}
        print(json.dumps({"learned": learned}, default=float), flush=True)
    elif phase == 16:
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            bf=ds.fx * ds.baseline, depth_threshold=35.0)
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
                  for i in range(cs.MAST3R_FRAMES)]
        rgbd_frames = cs.render(cs.render_rgbd_frames, 3)
        t0 = time.time()
        dense = {"loftr": cs.loftr_phase(dev, rgbd_frames),
                 "mast3r": cs.mast3r_phase(dev, frames, cam, ds),
                 "vpr": cs.vpr_phase(dev, frames)}
        if arg == "16":
            loop_frames = cs.render(cs.render_loop_frames, cs.LOOP_FRAMES)
            vl = dense["vlad_stage"] = cs.loop_phase(
                dev, (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy), loop_frames, loop="VLAD")
            assert vl["loops_closed"] >= cs.VLAD_MIN_LOOPS, vl
        print(json.dumps({"dense": dense}, default=float), flush=True)
    elif phase == 17:
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            bf=ds.fx * ds.baseline, depth_threshold=35.0)
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
                  for i in range(cs.N_FRAMES if arg == "17" else 1)]
        t0 = time.time()
        out = (cs.depth_phase(dev, frames, cam, ds) if arg == "17"
               else {"models": cs.depth_models_phase(dev, frames)})
        print(json.dumps({"depth": out}, default=float), flush=True)
    elif phase == 18:
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            bf=ds.fx * ds.baseline, depth_threshold=35.0)
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
                  for i in range(cs.N_FRAMES if arg == "18" else 1)]
        t0 = time.time()
        out = (cs.semantic_phase(dev, frames, cam, ds) if arg == "18"
               else {"models": cs.semantic_models_phase(dev, frames)})
        print(json.dumps({"semantic": out}, default=float), flush=True)
    elif phase == 19:
        if arg == "19a":
            t0 = time.time()
            out = {"models": cs.recon_models_phase(dev, cs.scene_views())}
        else:
            rgbd_frames = cs.render(cs.render_rgbd_frames, cs.GS_FRAMES)
            cam_rgbd = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                                     bf=ds.fx * cs.BASELINE_M, depth_threshold=35.0)
            t0 = time.time()
            out = cs.reconstruction_phase(dev, rgbd_frames, cam_rgbd, cs.bench_stream("RGBD"))
        print(json.dumps({"reconstruction": out}, default=float), flush=True)
    elif phase == 20:
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            bf=ds.fx * ds.baseline, depth_threshold=35.0)
        n = max(cs.LARGE_BA_FRAMES, cs.BAG_FRAMES) if arg == "20" else 0
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i)) for i in range(n)]
        t0 = time.time()
        out = {"train": cs.trainer_phase(dev)}
        if arg == "20":
            out["large_ba"], slam = cs.large_ba_phase(dev, frames[:cs.LARGE_BA_FRAMES], cam)
            out["bag"] = cs.bag_phase(dev, frames[:cs.BAG_FRAMES], cam)
            out["viewer"] = cs.viewer_phase(slam)
        print(json.dumps({"trainers": out}, default=float), flush=True)
    elif phase == 21:
        import shutil
        import tempfile

        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
                  for i in range(cs.N_FRAMES)]
        root = tempfile.mkdtemp(prefix="chip_phase_state_")
        try:
            state = os.path.join(root, "state")
            cs.entry_phase(dev, frames, ds, keep_state=state)
            t0 = time.time()
            print(json.dumps({"distributed": cs.distributed_phase(dev, state, frames, ds)},
                             default=float), flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    else:
        raise SystemExit(f"phase {phase}: only 8 and 12-21 run alone")
    print(f"phase {phase}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
