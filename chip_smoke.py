#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pyslam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (one line each, and any failure exits non-zero):
  1. device: a CUDA card must be present (no CPU fallback);
  2. build: compile the hand-written kernels from pyslam_tpu_torch/csrc, one
     nvcc per source, and print what ptxas reports for each;
  3. the FAST+NMS kernel against its plain PyTorch version, bit for bit:
     the one-launch pyramid call on the 8 levels of a 376x1241 stereo pair,
     the one-level call on each level and on three small test images, and
     the per-level kernel it replaced; then their times from CUDA-graph
     replays of 100 back-to-back launches (per frame and per level), the
     plain version's time, and the bound computed from this frame's pixels;
  4. tie order on the card: torch.argmin / argmax keep the first index and
     torch.sort(stable=True) keeps the input order of equal keys, at the
     shapes the matchers and the keypoint selection use;
  5. one 376x1241 stereo frame extracted on the card and on the CPU;
  6. the main path: 60 frames of the 376x1241 synthetic stereo stream (16000
     world points, straight line, 0.8 m a frame) through Slam.track() with
     next-frame prefetch, then finish(); checks kernel launches (one a
     frame), keyframes, local BA, tracked frames and ATE.
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
BORDER = 16
ATE_MAX = 3.0
# H100 SXM published peaks at 700 W (NVIDIA data sheet): HBM bytes a second,
# and float32 operations a second outside the tensor cores counting a
# min, max, subtract or compare as one (67 TFLOP/s counts an FMA as two)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 33.5e12
# float32 operations in csrc/fast_nms.cu: the NMS of every pixel (8 max,
# compare, select), the compass pretest of every pixel inside the border
# (4 subtract, 8 compare), and each side that passes it (64 doubling + 15
# reduce min/max, subtract, compare, max or select)
OPS_NMS, OPS_PRETEST, OPS_SIDE = 10, 12, 82
GRAPH_LAUNCHES = 100


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
    """Median of n timings of one eager call (CUDA events around it)."""
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


def graph_ms(fn, n=GRAPH_LAUNCHES, reps=5):
    """Device time of one call of fn: fn captured n times back to back in a
    CUDA graph, one event pair around a replay, divided by n; the median of
    reps replays after a warm-up (the host's enqueue time is not in it)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def fast_work(levels, threshold, border):
    """Bytes and float32 operations the FAST+NMS kernel's function needs on
    these levels: inputs read once, outputs written once, and a side's full
    score only where the kernel's compass pretest lets it through (two
    neighbouring compass points past the threshold); with the share of
    interior pixels that pass on some side."""
    import torch

    from pyslam_tpu_torch.ops.fast import CIRCLE

    n_bytes = n_ops = n_inside = n_pass = 0
    for x in levels:
        b, h, w = x.shape
        n_bytes += 2 * 4 * x.numel()
        n_ops += OPS_NMS * x.numel()
        inner = x[:, border:h - border, border:w - border]
        if inner.numel() == 0:
            continue
        d = [x[:, border + dy:h - border + dy, border + dx:w - border + dx] - inner
             for dy, dx in (CIRCLE[0], CIRCLE[4], CIRCLE[8], CIRCLE[12])]
        sides = []
        for flags in ([v > threshold for v in d], [v < -threshold for v in d]):
            sides.append(flags[0] & flags[1] | flags[1] & flags[2] | flags[2] & flags[3]
                         | flags[3] & flags[0])
        n_inside += inner.numel()
        n_pass += int((sides[0] | sides[1]).sum())
        n_ops += OPS_PRETEST * inner.numel() + OPS_SIDE * int(sides[0].sum() + sides[1].sum())
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_OPS_S * 1e3
    return dict(bytes=n_bytes, ops=n_ops, pass_share=n_pass / max(n_inside, 1),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def check_ties(dev):
    """First-index argmin / argmax and stable sort on the card, held to
    numpy (which keeps the first index and, with kind="stable", the input
    order) on integer-valued keys with many ties."""
    import torch

    rng = np.random.default_rng(1)
    checked = 0
    for shape in ((2000, 2000), (2000, 8192), (4, 2000, 2000)):
        for dtype in (torch.int32, torch.float32):
            keys = rng.integers(0, 4, shape)
            x = torch.as_tensor(keys).to(dev, dtype)
            for dim in (-1, -2):
                for name, fn, ref in (("argmin", torch.argmin, np.argmin),
                                      ("argmax", torch.argmax, np.argmax)):
                    got = fn(x, dim).cpu().numpy()
                    assert np.array_equal(got, ref(keys, axis=dim)), (name, shape, dtype, dim)
                    checked += 1
    # the keypoint selection's sorts: (2, cells, 256) blocks and the flat
    # survivors, descending, with ties and -inf
    for shape in ((2, 1872, 256), (2, 1872 * 6)):
        keys = rng.integers(0, 6, shape).astype(np.float32) * 10.0
        keys[keys == 0.0] = -np.inf
        idx = torch.sort(torch.as_tensor(keys).to(dev), dim=-1, descending=True,
                         stable=True)[1].cpu().numpy()
        assert np.array_equal(idx, np.argsort(-keys, axis=-1, kind="stable")), shape
        checked += 1
    return checked


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
    from pyslam_tpu_torch.ops.fast import fast_nms, fast_nms_plain, fast_nms_pyramid
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    lib = _build.load()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s)")
    for line in _build.ptxas_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # ---------------------------------------------------------------- 3
    ds = bench_stream()
    left0, right0 = ds.getImage(0), ds.getImageRight(0)
    pair = torch.as_tensor(np.stack([left0, right0])).to(dev)
    levels = [lvl.contiguous() for lvl in image_ops.build_pyramid(pair, N_LEVELS, 1.2)]
    names = [f"level{lv} 2x{x.shape[1]}x{x.shape[2]}" for lv, x in enumerate(levels)]
    plain = [fast_nms_plain(x, FAST_TH) for x in levels]
    before = fast_nms.launches
    got = fast_nms_pyramid(levels, FAST_TH)
    torch.cuda.synchronize()
    assert fast_nms.launches == before + 1, "the pyramid call is not one launch"
    max_err = 0.0
    per_level_out = [torch.empty_like(x) for x in levels]

    def per_level(lv):
        x, o = levels[lv], per_level_out[lv]
        err = lib.pyslam_fast_nms_per_level(
            x.data_ptr(), o.data_ptr(), x.shape[0], x.shape[1], x.shape[2], FAST_TH, BORDER,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"per-level kernel launch failed: cudaError {err}"

    for lv, name in enumerate(names):
        one = fast_nms(levels[lv], FAST_TH)
        per_level(lv)
        torch.cuda.synchronize()
        assert int((plain[lv] > 0).sum()) > 0, f"no corners at {name}"
        for what, x in (("pyramid call", got[lv]), ("one-level call", one),
                        ("per-level kernel", per_level_out[lv])):
            assert torch.equal(x, plain[lv]), f"{what} differs from the plain version at {name}"
            max_err = max(max_err, float((x - plain[lv]).abs().max()))
    rng = np.random.default_rng(0)
    ties = np.floor(rng.uniform(0, 8, (120, 160))).astype(np.float32) * 32.0
    for name, img in (("synth 1x150x200", synth_image(rng, 150, 200)),
                      ("band 1x113x160", band_image(rng)), ("ties 1x120x160", ties)):
        x = torch.as_tensor(img)[None].to(dev)
        ref = fast_nms_plain(x, FAST_TH)
        assert int((ref > 0).sum()) > 0, f"no corners at {name}"
        assert torch.equal(fast_nms(x, FAST_TH), ref), f"fast_nms differs at {name}"
        assert torch.equal(fast_nms_pyramid([x], FAST_TH)[0], ref), f"pyramid differs at {name}"
    log(f"[kernel] fast_nms: the one-launch pyramid call, the one-level call and the "
        f"per-level kernel equal the plain version at {len(names)} levels and 3 small images")

    work = fast_work(levels, FAST_TH, BORDER)
    new_frame = lambda: fast_nms_pyramid(levels, FAST_TH)  # noqa: E731
    old_frame = lambda: [per_level(lv) for lv in range(len(levels))]  # noqa: E731
    t_old1 = graph_ms(old_frame)
    t_new1 = graph_ms(new_frame)
    t_new2 = graph_ms(new_frame)
    t_old2 = graph_ms(old_frame)
    kern_ms = statistics.median([t_new1, t_new2])
    before_ms = statistics.median([t_old1, t_old2])
    eager_ms = median_ms(new_frame)
    plain_ms = median_ms(lambda: [fast_nms_plain(x, FAST_TH) for x in levels], n=10)
    for lv, name in enumerate(names):
        w_lv = fast_work([levels[lv]], FAST_TH, BORDER)
        log(f"[kernel] {name}: one-level call {graph_ms(lambda: fast_nms(levels[lv], FAST_TH)):.4f}"
            f" ms, per-level kernel {graph_ms(lambda: per_level(lv)):.4f} ms, bound "
            f"{w_lv['bound_ms']:.4f} ms ({w_lv['bound_by']}), pretest passes "
            f"{w_lv['pass_share'] * 100:.2f}% of the interior")
    log(f"[kernel] fast_nms, 8 levels of a stereo pair, per frame (CUDA-graph replays of "
        f"{GRAPH_LAUNCHES} launches, new/old in turns {t_old1:.4f} {t_new1:.4f} {t_new2:.4f} "
        f"{t_old2:.4f}): one launch {kern_ms:.4f} ms, the per-level kernel (8 launches) "
        f"{before_ms:.4f} ms, one eager call {eager_ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}: {work['bytes']} B, "
        f"{work['ops']} operations; pretest passes {work['pass_share'] * 100:.2f}% of the "
        f"interior), {work['bound_ms'] / kern_ms * 100:.1f}% of it")

    # ---------------------------------------------------------------- 4
    n_checks = check_ties(dev)
    log(f"[ties] argmin/argmax keep the first index and the stable sort keeps input order "
        f"on the card: {n_checks} checks")

    # ---------------------------------------------------------------- 5
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

    # ---------------------------------------------------------------- 6
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
    assert launches == N_FRAMES, f"{launches} fast_nms launches for {N_FRAMES} frames"
    assert n_kfs >= 2 and n_lba >= 1, (n_kfs, n_lba)
    assert n_tracked >= 0.9 * N_FRAMES, n_tracked
    assert np.isfinite(poses).all() and ate < ATE_MAX, ate

    # ---------------------------------------------------------------- 7
    print(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda",
        "source": "pyslam_tpu_torch/csrc/fast_nms.cu",
        "replaces": "pyslam_tpu/ops/pallas_fast.py:95",
        "launches": launches, "launches_per_frame": launches / N_FRAMES,
        "max_abs_err": max_err, "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": work["bound_ms"], "bound_by": work["bound_by"], "library_ms": None,
        "before_ms": before_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
