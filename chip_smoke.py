#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pyslam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (one line each, and any failure exits non-zero):
  1. device: a CUDA card must be present (no CPU fallback);
  2. build: compile the hand-written kernels from pyslam_tpu_torch/csrc;
  3. the FAST+NMS kernel against its plain PyTorch version, bit for bit, at
     the 8 pyramid-level shapes of a 376x1241 stereo pair and on two small
     test images, with the median time of each over 20 runs;
  4. one 376x1241 stereo frame extracted on the card and on the CPU;
  5. the main path: 60 frames of the 376x1241 synthetic stereo stream (16000
     world points, straight line, 0.8 m a frame) through Slam.track() with
     next-frame prefetch, then finish(); checks kernel launches, keyframes,
     local BA, tracked frames and ATE.
It ends with a JSON line of kernel results, the card's name and power limit,
and, last, {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

H, W = 376, 1241
FX = 718.856
BASELINE_M = 0.54
N_FEATURES = 2000
N_LEVELS = 8
N_FRAMES = 60
FAST_TH = 20.0
ATE_MAX = 3.0


def log(msg):
    print(msg, flush=True)


def synth_image(rng, h, w, n_blobs=80):
    """Random rectangles on a gradient background (many corners)."""
    img = np.tile(np.linspace(40, 90, w, dtype=np.float32), (h, 1))
    for _ in range(n_blobs):
        y = rng.integers(20, h - 40)
        x = rng.integers(20, w - 40)
        bh = rng.integers(6, 24)
        bw = rng.integers(6, 24)
        img[y:y + bh, x:x + bw] = rng.uniform(120, 250)
    return img


def band_image(rng, band=32):
    """Corners on the row-band boundaries of the TPU kernel's tiling."""
    h, w = 3 * band + 17, 160
    img = np.full((h, w), 50.0, np.float32)
    for yc in (band, 2 * band - 1, 2 * band):
        img[yc - 4:yc + 4, 60:80] = 200.0
        img[yc - 4:yc + 4, 100:120] = 220.0
    return img + rng.uniform(0.0, 2.0, (h, w)).astype(np.float32)


def bench_stream():
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset, SyntheticWorld

    extent = max(60.0, (N_FRAMES * 0.8 + 30.0) / 1.4)
    world = SyntheticWorld(n_points=16000, extent=extent, depth_range=(4.0, 80.0))
    return SyntheticDataset(num_frames=N_FRAMES, h=H, w=W, fx=FX, baseline=BASELINE_M,
                            trajectory="line", step=0.8, sensor_type=SensorType.STEREO,
                            world=world)


def median_ms(fn, n=20):
    import torch

    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    import torch

    # ---------------------------------------------------------------- 1
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port runs on the GPU only")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    import pyslam_tpu_torch  # noqa: F401  (precision policy)
    from pyslam_tpu_torch import _build
    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.orb2 import ORB2Extractor
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops import image as image_ops
    from pyslam_tpu_torch.ops.fast import fast_nms, fast_nms_plain
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s)")

    # ---------------------------------------------------------------- 3
    ds = bench_stream()
    left0, right0 = ds.getImage(0), ds.getImageRight(0)
    pair = torch.as_tensor(np.stack([left0, right0])).to(dev)
    levels = image_ops.build_pyramid(pair, N_LEVELS, 1.2)
    rng = np.random.default_rng(0)
    cases = [(f"level{lv} 2x{lvl.shape[1]}x{lvl.shape[2]}", lvl.contiguous())
             for lv, lvl in enumerate(levels)]
    cases.append(("synth 1x150x200",
                  torch.as_tensor(synth_image(rng, 150, 200))[None].to(dev)))
    cases.append(("band 1x113x160", torch.as_tensor(band_image(rng))[None].to(dev)))
    max_err = 0.0
    kern_ms = plain_ms = 0.0
    for name, x in cases:
        got = fast_nms(x, FAST_TH)
        ref = fast_nms_plain(x, FAST_TH)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"fast_nms differs from the plain version at {name}"
        assert int((ref > 0).sum()) > 0, f"no corners at {name}"
        max_err = max(max_err, float((got - ref).abs().max()))
        k_ms = median_ms(lambda: fast_nms(x, FAST_TH))
        p_ms = median_ms(lambda: fast_nms_plain(x, FAST_TH))
        if name.startswith("level"):
            kern_ms += k_ms
            plain_ms += p_ms
        log(f"[kernel] fast_nms {name}: equal, {int((ref > 0).sum())} corners, "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    log(f"[kernel] fast_nms all 8 levels of a stereo pair: kernel {kern_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")

    # ---------------------------------------------------------------- 4
    bf = FX * BASELINE_M
    args = dict(bf=bf, max_disp=bf / 0.1, max_distance=100.0, row_tol=2.0)
    fg, urg, _ = ORB2Extractor(N_FEATURES, N_LEVELS, device=dev).extract_stereo(
        left0, right0, **args)
    fc, urc, _ = ORB2Extractor(N_FEATURES, N_LEVELS, device="cpu").extract_stereo(
        left0, right0, **args)
    xyg, xyc = fg.xy.cpu().numpy(), fc.xy.numpy()
    same = np.all(xyg == xyc, 1) & (fg.level.cpu().numpy() == fc.level.numpy())
    shared = same & fg.valid.cpu().numpy() & fc.valid.numpy()
    desc_eq = bool(np.array_equal(fg.desc.cpu().numpy()[shared], fc.desc.numpy()[shared]))
    n_match = int((urg >= 0).sum())
    log(f"[frame] card vs CPU: {same.mean() * 100:.2f}% identical keypoints, descriptor "
        f"bits {'identical' if desc_eq else 'DIFFER'} on {int(shared.sum())} shared, "
        f"{n_match} stereo matches on the card ({int((urc >= 0).sum())} on the CPU)")
    assert same.mean() >= 0.99 and desc_eq and n_match > 0

    # ---------------------------------------------------------------- 5
    t0 = time.perf_counter()
    frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
              for i in range(N_FRAMES)]
    log(f"[main] rendered {N_FRAMES} stereo frames {H}x{W} in "
        f"{time.perf_counter() - t0:.1f} s")
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=35.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType.STEREO, device=dev)
    torch.cuda.synchronize()
    fast_nms.launches = 0
    lats = []
    t_start = None
    for i, (img_l, img_r, ts) in enumerate(frames):
        if i == 10:
            t_start = time.perf_counter()
        nxt = None
        if i + 1 < N_FRAMES:
            nl, nr, nts = frames[i + 1]
            nxt = {"img": nl, "img_right": nr, "frame_id": i + 1, "timestamp": nts}
        t1 = time.perf_counter()
        slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts, next_input=nxt)
        lats.append(time.perf_counter() - t1)
        if i % 10 == 0:
            log(f"[main] frame {i}: {lats[-1] * 1e3:.1f} ms, "
                f"{slam.map.num_keyframes()} keyframes, {slam.map.num_points()} points")
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = fast_nms.launches
    n_tracked = len(slam.tracking.history.timestamps)
    ts_est, poses = slam.get_final_trajectory()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(N_FRAMES)])
    ate = eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:, :3, 3], align=True,
                   with_scale=False).rmse
    lat_ms = np.asarray(lats[10:]) * 1e3
    n_kfs = slam.map.num_keyframes()
    n_lba = slam.local_mapping.lba_applied
    log(f"[main] {(N_FRAMES - 10) / wall:.2f} FPS over frames 10-{N_FRAMES - 1} (incl. final "
        f"drain), latency p50 {np.percentile(lat_ms, 50):.1f} ms p95 "
        f"{np.percentile(lat_ms, 95):.1f} ms; {n_tracked}/{N_FRAMES} tracked, {n_kfs} "
        f"keyframes, {slam.map.num_points()} points, {n_lba} local BAs applied, "
        f"ATE {ate:.4f} m; fast_nms launches {launches}")
    log("[main] stage totals: " + json.dumps(
        {mod: {k: round(v["total_ms"], 1) for k, v in st.items()}
         for mod, st in slam.timings().items()}))
    assert launches == N_LEVELS * N_FRAMES, f"{launches} fast_nms launches"
    assert n_kfs >= 2 and n_lba >= 1, (n_kfs, n_lba)
    assert n_tracked >= 0.9 * N_FRAMES, n_tracked
    assert np.isfinite(poses).all() and ate < ATE_MAX, ate

    # ---------------------------------------------------------------- 6
    print(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda",
        "source": "pyslam_tpu_torch/csrc/fast_nms.cu",
        "replaces": "pyslam_tpu/ops/pallas_fast.py:95",
        "launches": launches, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
