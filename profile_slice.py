#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one GPU.

    python3 profile_slice.py [--frames 30]

Drives the stream of chip_smoke.py (376x1241 synthetic stereo, 2000 ORB2
features over 8 levels) through Slam.track(), with the TSDF integrator and
its SGM depth attached as chip_smoke.py's main path attaches it (bench.py's
main stage), and prints:
  - a torch.profiler window over frames 15-24: wall time, summed self device
    time and the device's busy share, the number of CUDA kernel launches, the
    host time spent in cudaLaunchKernel, and the top ops by device and by
    host time;
  - the per-stage totals of Slam.timings() over the whole run (the
    integrator's SGM and TSDF stages among them) and the volume's size;
  - isolated times, at main-path shapes, of pose_optimization (N = 2000),
    extract_stereo of one 376x1241 pair and search_by_projection (M = 8192 map
    points x N = 2000 keypoints).
Every time is printed beside the card's name and power limit.
"""

import argparse
import json
import subprocess
import time

import numpy as np

import chip_smoke

WINDOW = (15, 25)


def host_ms(fn, n=5):
    """Mean host wall time of ``fn`` after one warm-up call, synchronised."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=30)
    n_frames = ap.parse_args().frames
    if n_frames < WINDOW[1]:
        raise SystemExit(f"--frames must be >= {WINDOW[1]}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    import pyslam_tpu_torch  # noqa: F401  (precision policy)
    from pyslam_tpu_torch.features.orb2 import ORB2Extractor
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops import optim, slam_matching
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    chip_smoke.N_FRAMES = n_frames
    ds = chip_smoke.bench_stream()
    frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
              for i in range(n_frames)]
    bf = ds.fx * ds.baseline
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=bf,
                        depth_threshold=35.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=chip_smoke.N_FEATURES,
                                          num_levels=chip_smoke.N_LEVELS),
                sensor_type=SensorType.STEREO, device=dev)
    integ = chip_smoke.build_integrator(cam, dev)
    slam.set_volumetric_integrator(integ)

    def step(i):
        nxt = None
        if i + 1 < n_frames:
            nl, nr, nts = frames[i + 1]
            nxt = {"img": nl, "img_right": nr, "frame_id": i + 1, "timestamp": nts}
        slam.track(frames[i][0], img_right=frames[i][1], frame_id=i,
                   timestamp=frames[i][2], next_input=nxt)

    for i in range(WINDOW[0]):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(*WINDOW):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    # device time from the kernel events alone (an op's self device time
    # repeats the time of the kernels it launched)
    dev_ms = sum(e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA) / 1e3
    cpu_ms = sum(e.self_cpu_time_total for e in ka) / 1e3
    launch_ms = sum(e.self_cpu_time_total for e in ka if e.key == "cudaLaunchKernel") / 1e3
    n_launch = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    n_win = WINDOW[1] - WINDOW[0]
    print(f"window frames {WINDOW[0]}-{WINDOW[1] - 1}: wall {wall_ms:.1f} ms, summed self "
          f"device time {dev_ms:.1f} ms, busy share {dev_ms / wall_ms:.4f}; "
          f"{n_launch} cudaLaunchKernel calls ({n_launch / n_win:.0f} a frame), "
          f"{launch_ms:.1f} ms of {cpu_ms:.1f} ms self host time in them")
    print(ka.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=50))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=50))

    for i in range(WINDOW[1], n_frames):
        step(i)
    slam.finish()
    print("stage totals (ms): " + json.dumps(
        {mod: {k: round(v["total_ms"], 1) for k, v in st.items()}
         for mod, st in slam.timings().items()}))
    print(f"volume: {integ.volume.num_voxels()} voxels from {integ.volume.num_integrated} "
          f"keyframes, load factor {integ.volume.num_voxels() / integ.volume.capacity:.4f}")

    r = np.random.default_rng(0)
    n, m = chip_smoke.N_FEATURES, 8192
    pts = torch.as_tensor(np.c_[r.uniform(-5, 5, (n, 2)),
                                r.uniform(4, 40, (n, 1))].astype(np.float32)).to(dev)
    K = torch.as_tensor(cam.K, dtype=torch.float32).to(dev)
    T = torch.eye(4, device=dev)
    uv = pts[:, :2] / pts[:, 2:] * K[0, 0] + K[0, 2]
    ones_n = torch.ones(n, device=dev)
    valid_n = torch.ones(n, dtype=torch.bool, device=dev)
    print("pose_optimization N=%d: %.2f ms" % (n, host_ms(lambda: optim.pose_optimization(
        T, pts, uv, torch.full((n,), -1.0, device=dev), ones_n, valid_n, K,
        bf=torch.tensor(bf, device=dev))[0])))

    ext = ORB2Extractor(chip_smoke.N_FEATURES, chip_smoke.N_LEVELS, device=dev)
    print("extract_stereo %dx%d: %.2f ms" % (ds.h, ds.w, host_ms(lambda: ext.extract_stereo(
        frames[0][0], frames[0][1], bf=bf, max_disp=bf / 0.1, max_distance=100.0,
        row_tol=2.0)[1].cpu())))

    mp = torch.as_tensor(np.c_[r.uniform(-20, 20, (m, 2)),
                               r.uniform(4, 60, (m, 1))].astype(np.float32)).to(dev)
    mdesc = torch.randint(0, 2, (m, 256), dtype=torch.int8, device=dev)
    kdesc = torch.randint(0, 2, (n, 256), dtype=torch.int8, device=dev)
    kps = torch.as_tensor(r.uniform([0, 0], [ds.w, ds.h], (n, 2)).astype(np.float32)).to(dev)
    bounds = torch.tensor([0.0, ds.w, 0.0, ds.h], device=dev)
    scales = torch.tensor([1.2 ** lv for lv in range(chip_smoke.N_LEVELS)], device=dev)
    normals = mp / torch.linalg.norm(mp, dim=1, keepdim=True)
    print("search_by_projection M=%d N=%d: %.2f ms" % (m, n, host_ms(
        lambda: slam_matching.search_by_projection(
            mp, mdesc, normals, torch.full((m,), 1.0, device=dev),
            torch.full((m,), 100.0, device=dev), torch.ones(m, dtype=torch.bool, device=dev),
            kps, torch.randint(0, chip_smoke.N_LEVELS, (n,), device=dev), kdesc, valid_n,
            torch.full((n,), -1.0, device=dev), T, K, bounds, scales, 3.0, 50.0,
            ratio=0.8)[1])))
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
