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
the learned segmenters' sessions; ``18a`` the models alone).

    PYTHONPATH=. python3 tests/torch_chip_phase.py 8|12|13|14|15|16|16abc|17|17a|18|18a

Builds the kernels, renders the phase's frames as chip_smoke.py does and
runs its function for the phase; prints what the phase prints.  Run from
the root of a tree (the repository, or an unpacked ``git archive`` of
another commit, to compare two commits in one call on one card).
"""

import json
import subprocess
import sys
import time

import chip_smoke as cs


def main():
    import torch

    from pyslam_tpu_torch import _build
    from pyslam_tpu_torch.slam.camera import PinholeCamera

    arg = sys.argv[1]
    phase = int(arg[:2]) if arg[:2] in ("16", "17", "18") else int(arg)
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
        print(json.dumps({"entry": cs.entry_phase(dev, frames, ds)}, default=float), flush=True)
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
    else:
        raise SystemExit(f"phase {phase}: only 8, 12, 13, 14, 15, 16, 17 and 18 run alone")
    print(f"phase {phase}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
