"""chip_smoke.py phase 21c's evaluation-grid cells, run by the JAX package
and by the port on the same frames.

    python -m tests.torch_eval_grid_witness [--package both|jax|port]
                                            [--sequences 0,1] [--frames 10]
                                            [--log-kf] [--reference-pyramid]
                                            [--out DIR]

Renders phase 21c's sequences once with the port's own
``io/synthetic.py`` (``chip_smoke.grid_stream(k)``: the main stage's
16000-point world and 376x1241 width on a straight line at a step of
0.30 + 0.02 k m), writes each as a KITTI sequence (uint8 PNGs, times and
poses; ``chip_smoke.write_kitti_sequence``) under ``--out`` (a temporary
directory by default), and hands the same files to each package's
``SlamEvaluationManager._single_run(..., deterministic=True)``: ORB2 at
2000 features on 8 levels, no loop detector, depth threshold 35, local
mapping drained after every frame, so that the back end's readiness
cannot part the two.  The JAX package runs with x64 off, as outside the
tests; the port on the CPU.  Prints, a cell and a package: the frames
tracked, the frames that made a keyframe, the keyframes and points left
in the map, the percentage lost and the ATE, and how far frame 1 (the
first frame tracked, from frame 0's pose without a motion model) was
placed from frame 0 beside the ground truth's step.  ``--log-kf`` prints every
frame's ``[kf?]`` decision line in both packages; ``--reference-pyramid``
starts the port's ORB2 extraction from the JAX package's image pyramid
(``tests.torch_parity.port_extracts_from_the_reference_pyramid``), which takes the
pyramid's FMA deviation out of the comparison.
"""

import argparse
import contextlib
import os
import tempfile
import time

import numpy as np

import chip_smoke


def write_sequences(root, seqs, n):
    """KITTI sequences ``{k:02d}`` under ``root``; their dataset settings
    without the camera."""
    out = []
    for k in seqs:
        ds = chip_smoke.grid_stream(k)
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i)) for i in range(n)]
        name = f"{k:02d}"
        seq_root = os.path.join(root, name)
        chip_smoke.write_kitti_sequence(seq_root, frames, ds)
        os.rename(os.path.join(seq_root, "sequences", "00"),
                  os.path.join(seq_root, "sequences", name))
        out.append({"type": "kitti", "base_path": seq_root, "name": name,
                    "sensor_type": "stereo",
                    "groundtruth": {"type": "kitti",
                                    "path": os.path.join(seq_root, "poses", "00.txt"),
                                    "times_path": os.path.join(seq_root, "sequences", name,
                                                               "times.txt")}})
    return out


def run_package(package, datasets, log_kf, reference_pyramid):
    """{sequence: (result, frames tracked, frames that made a keyframe)}."""
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", False)
        from pyslam_tpu.config_parameters import Parameters
        from pyslam_tpu.evaluation import manager
        from pyslam_tpu.features.tracker import FeatureTrackerConfig
        from pyslam_tpu.slam.camera import PinholeCamera
        kw = {}
    else:
        from pyslam_tpu_torch.config_parameters import Parameters
        from pyslam_tpu_torch.evaluation import manager
        from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
        from pyslam_tpu_torch.slam.camera import PinholeCamera
        kw = {"device": "cpu"}
    fed = contextlib.nullcontext()
    if package == "port" and reference_pyramid:
        from tests.torch_parity import port_extracts_from_the_reference_pyramid

        fed = port_extracts_from_the_reference_pyramid()
    saved = Parameters.as_dict()
    Parameters.kLogKeyFrameDecision = log_kf
    trace = {}

    class TracedSlam(manager.Slam):
        def track(self, img, img_right=None, depth=None, frame_id=0, timestamp=0.0, **kwargs):
            out = super().track(img, img_right=img_right, depth=depth, frame_id=frame_id,
                                timestamp=timestamp, **kwargs)
            tracked, kf_frames, moved = trace.setdefault("cur", ([], [], []))
            if self.state.name == "OK":
                tracked.append(frame_id)
            kf = self.tracking.kf_ref
            if kf is not None and kf.id == frame_id:
                kf_frames.append(frame_id)
            if frame_id == 1:   # the first frame tracked, from frame 0's pose
                moved.append(float(np.linalg.norm(np.linalg.inv(self.tracking.f_prev.Tcw)[:3, 3])))
            return out

    ds0 = chip_smoke.grid_stream(0)
    cam = PinholeCamera(ds0.w, ds0.h, ds0.fx, ds0.fy, ds0.cx, ds0.cy, fps=ds0.fps,
                        bf=ds0.fx * chip_smoke.BASELINE_M, depth_threshold=35.0)
    preset = FeatureTrackerConfig(num_features=chip_smoke.N_FEATURES,
                                  num_levels=chip_smoke.N_LEVELS)
    cfg = manager.EvalConfig(datasets=[dict(d, camera=cam) for d in datasets],
                             presets={"orb2": preset}, runs_per_dataset=1, loop_detector=None)
    orig = manager.Slam
    manager.Slam = TracedSlam
    out = {}
    try:
        with fed, tempfile.TemporaryDirectory(prefix="eval_grid_witness_") as reports:
            mgr = manager.SlamEvaluationManager(cfg, out_dir=reports, **kw)
            for d in cfg.datasets:
                t0 = time.perf_counter()
                r = mgr._single_run(d, "orb2", preset, 0, deterministic=True)
                tracked, kf_frames, moved = trace.pop("cur")
                out[d["name"]] = (r, tracked, kf_frames)
                step = float(np.linalg.norm(np.loadtxt(d["groundtruth"]["path"])[1, 3::4]))
                print(f"{package} sequence {d['name']}: frame 1 tracked {moved[0]:.4f} m from "
                      f"frame 0 (ground truth {step:.2f} m); tracked {tracked}, keyframes made at "
                      f"{kf_frames}; {r.num_keyframes} keyframes and {r.num_points} points in "
                      f"the map, {r.percent_lost:.1f} % lost, ATE {r.ate_rmse:.4f} m "
                      f"({time.perf_counter() - t0:.0f} s)", flush=True)
    finally:
        manager.Slam = orig
        Parameters.set_from_dict(saved)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("both", "jax", "port"), default="both")
    ap.add_argument("--sequences", default="0,1")
    ap.add_argument("--frames", type=int, default=chip_smoke.EVAL_GRID_FRAMES)
    ap.add_argument("--log-kf", action="store_true")
    ap.add_argument("--reference-pyramid", action="store_true")
    ap.add_argument("--out", default=None, help="directory to keep the KITTI sequences in")
    args = ap.parse_args()
    seqs = [int(k) for k in args.sequences.split(",")]
    with tempfile.TemporaryDirectory(prefix="eval_grid_seqs_") as tmp:
        root = args.out or tmp
        datasets = write_sequences(root, seqs, args.frames)
        packages = ("jax", "port") if args.package == "both" else (args.package,)
        res = {p: run_package(p, datasets, args.log_kf, args.reference_pyramid)
               for p in packages}
    if len(res) == 2:
        for d in datasets:
            (rj, tj, kj), (rp, tp, kp) = res["jax"][d["name"]], res["port"][d["name"]]
            first = next((f for f in range(args.frames) if (f in kj) != (f in kp)), None)
            print(f"sequence {d['name']}: tracked {'equal' if tj == tp else 'different'}, "
                  f"keyframe frames {'equal' if kj == kp else 'part at frame ' + str(first)}; "
                  f"ATE reference {rj.ate_rmse:.4f} m, port {rp.ate_rmse:.4f} m "
                  f"(difference {abs(rj.ate_rmse - rp.ate_rmse):.4f})", flush=True)


if __name__ == "__main__":
    main()
