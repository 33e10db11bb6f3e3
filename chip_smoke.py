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
  6. the dense slice (plain PyTorch ops, no hand kernel): the integrator's
     SGM depth (downscale 2: 188x620, 32 disparities) of the first stereo
     pair on the card against the CPU, identical; that keyframe's 3 TSDF
     phases into a 1 << 22 table on the card against the CPU (slots, keys
     and occupied identical, tsdf/weight/color within 1e-5 relative); then
     on the card: kernel launches and summed kernel time of one SGM call
     and of one TSDF phase (torch.profiler), their times over back-to-back
     calls (CUDA events), their bounds, and the standalone TSDF rate of
     bench.py (376x1241 random depth of 4-60 m, stride 3, band 2);
  7. the main path: 60 frames of the 376x1241 synthetic stereo stream (16000
     world points, straight line, 0.8 m a frame) through Slam.track() with
     next-frame prefetch and the TSDF integrator with its SGM depth attached
     as bench.py attaches it, then finish(); checks kernel launches (one a
     frame), keyframes, local BA, tracked frames, ATE, and a non-empty
     volume that integrated every keyframe handed over; prints the table's
     load factor beside the capacity flag's sizing rule (<= 0.25), the share
     of a further keyframe's updates the final table would drop (both held
     under ceilings, LOAD_MAX and DROP_MAX), the stage totals and the peak
     device memory;
  8. the loop stage of bench.py:193-267: 150 frames of a 376x1241 stereo
     circle with a revisit tail (period 130, a 16000-point world of extent
     30 m, 2000 features on 8 levels, depth threshold 35) through
     Slam.track() with next-frame prefetch and the DBOW3 loop detector, then
     finish(); the frames are rendered first by worker processes.  Prints FPS, p50 / p95 latency over frames 8..149 and the slowest
     frame, loops closed, tracked frames, ATE before and after each
     correction and at the end, GBA runs applied and aborted, fast_nms
     launches and the loop-closing stage timers; asserts a loop closed, every
     frame tracked, ATE under the ceiling, a GBA applied and one fast_nms
     launch a frame.  Then, on the final map: a frame of the stage
     relocalised from a pose pushed 1.1 m away, and the loop event's device
     cost:
     kernel launches and summed kernel time (torch.profiler) of one
     geometry check, one correction (without its GBA), its pose graph alone,
     a GBA dispatch (problem and first chunk) and a GBA chunk;
  9. the RGBD stage: the 60 frames of phase 7's stream as left image and
     sensor depth through Slam(sensor_type=RGBD).track() with next-frame
     prefetch, bf = fx * 0.54 for the virtual right coordinates, and the
     TSDF integrator of phase 7 on the sensor depth (no SGM); asserts 60/60
     tracked, one fast_nms launch a frame, every keyframe integrated and ATE
     under the ceiling; prints FPS, p50 / p95 latency, keyframes, the load
     factor and the peak device memory;
 10. the monocular stage: the same 60 left images through
     Slam(sensor_type=MONOCULAR).track(); asserts initialisation no later
     than the JAX package's frame on the CPU plus a margin (MONO_*), every
     frame tracked from then on, one fast_nms launch a frame and ATE after a
     similarity alignment under the ceiling; prints what phase 9 prints and
     the initialising frame's latency;
 11. both visual odometries on those 60 frames (VisualOdometry with the
     ground-truth scale, VisualOdometryRgbd with 2000 corners): FPS, p50,
     ATE under their CPU floors, one fast_nms launch a frame; then, card
     against CPU on frames 0-1: compute_stereo_from_rgbd identical,
     find_essential + recover_pose from the same minimal samples, LK within
     1e-2 px; the launches and kernel time of one LK call, one
     find_essential + recover_pose and one monocular initialisation; and
     the kernel as these paths call it (the B = 1 pyramid, the threshold-15
     level) bit-equal to its plain version, timed beside its bound;
 12. the weight-free presets on phase 7's 60 stereo frames, each at its own
     width, with the session's descriptor gates restored afterwards; first
     every weight-free preset is built on the card through the factory and
     extracts frame 0, then:
     a. ORB2_BEBLID (512-bit BEBLID on ORB2 keypoints) with the
        DBOW3_INDEPENDENT loop detector: the 512-bit layout through map,
        keyframe store and vocabulary; asserts every frame tracked, ATE
        under FEATURE_ATE_MAX and one fast_nms launch a frame;
     b. ROOT_SIFT (cv2 SIFT on the host, RootSIFT descriptors) with
        DBOW3_INDEPENDENT: the float layout through the whole core; the
        same assertions without the kernel; when cv2 does not import it
        prints so on its own line and does not run;
     c. KAZE, card against CPU on frames 0-1: keypoints identical,
        descriptors within KAZE_DESC_TOL, the L2 brute-force matches and
        the float vocabulary's words identical; then a 20-frame KAZE stereo
        session on the card, its frames tracked and resets printed beside
        the JAX package's (which loses this stream at frame 1).
     Prints p50 / p95 latency, FPS, keyframes and ATE of each session and a
     ``features`` JSON line naming the sessions that ran.
It ends with a JSON line of kernel results, the card's name and power limit,
and, last, {"ok": true, "device": {...}}.
"""

import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

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
# the dense slice as bench.py:126-155 configures it
VOXEL_SIZE, SDF_TRUNC, DEPTH_TRUNC_OUTDOOR = 0.2, 0.6, 40.0
TABLE_CAPACITY = 1 << 22
TSDF_PHASES = 3
# operations of the SGM function per element, counting a min, add,
# compare, select, xor or popcount as one: the census compares of both
# images per pixel; per pixel and disparity the xor and popcount of the
# cost, the 3 adds of the 4 directions, and the winner-take-all, uniqueness
# and right-disparity minima; per step of a path, disparity and tile of the
# aggregation, the 7 of the recurrence (min of the neighbours, + P1, two
# mins, add, subtract, the running minimum)
OPS_CENSUS, OPS_COST, OPS_SUM4, OPS_WTA, OPS_STEP = 2 * 24, 2, 3, 5, 7
# bytes of one update read by the insert (coords, sdf, w, grey, valid) and
# of one table row read and written (key, occupied, tsdf, weight, color)
UPDATE_BYTES, ROW_BYTES = 3 * 4 + 4 + 4 + 4 + 1, 3 * 4 + 1 + 4 + 4 + 3 * 4
# bytes of one strided pixel read by the update generation (depth,
# intensity); its operations per pixel (2 ray directions of subtract and
# divide, 3 compares of the pixel's validity) and per update (sample depth;
# sdf subtract and divide; 2 ray products; per world coordinate a multiply,
# 2 FMAs and an add, a divide and a floor; weight clamp, multiply, subtract
# and clamp; 3 compares and 2 ands of its validity; the colour multiply)
PIXEL_BYTES, OPS_PIXEL, OPS_UPDATE = 4 + 4, 7, 1 + 2 + 2 + 3 * 6 + 4 + 5 + 1
# ceilings of the main path's dense result, over this configuration's chip
# readings (load factor 0.4141 and 0.4140, 3.06 % and 3.10 % of a further
# keyframe's valid updates dropped): the table overfills the capacity
# flag's sizing rule (<= 0.25) at bench.py's configuration, so these guard
# the insert against a regression, not the rule
LOAD_MAX, DROP_MAX = 0.45, 0.05
# the loop stage as bench.py:193-267 configures it
LOOP_FRAMES, LOOP_PERIOD = 150, 130
LOOP_SKIP = 8          # latency percentiles over frames 8.. (bench.py:251)
RELOC_FRAME = 60       # relocalised against the final map after the stage
RENDER_CHUNK = 10
# phases 9-11: the main stage's stream as RGBD (left image and its depth)
# and monocular (left image), and the visual odometries on it
VO_FAST_TH = 15.0      # the RGBD VO's FAST threshold (visual_odometry_rgbd.py)
# the JAX package on the monocular line (python -m tests.torch_sensor_stage
# --package jax --sensor mono, CPU, x64 off) initialises at frame 34; the
# port may take one more advance of the reference frame (every 10 failures)
MONO_REF_INIT_FRAME, MONO_INIT_MARGIN = 34, 10
# the floors of the visual odometries' CPU tests (tests/test_vo.py,
# tests/test_lk_vo_rgbd.py)
VO_MONO_ATE_MAX, VO_RGBD_ATE_MAX = 0.4, 0.35
# phase 12: the weight-free presets on the main stage's stream.  The JAX
# package (python -m tests.torch_sensor_stage --package jax --sensor stereo
# --preset P [--loop DBOW3_INDEPENDENT], CPU, x64 off) tracks all 60 frames
# with ORB2_BEBLID (18 keyframes, ATE 0.1515 m) and with ROOT_SIFT (60
# keyframes, ATE 0.0513 m), both with DBOW3_INDEPENDENT; it loses KAZE at
# frame 1 and resets (WITNESS_KAZE: 8 of 20 frames tracked, 7 resets)
FEATURE_ATE_MAX = 0.25
KAZE_FRAMES = 20
KAZE_DESC_TOL = 1e-3
WITNESS_KAZE = (8, 7)


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


def bench_stream(sensor="STEREO"):
    """The main stage's stream; ``sensor`` (STEREO, RGBD, MONOCULAR) sets
    which images it renders beside the left one."""
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset, SyntheticWorld

    extent = max(60.0, (N_FRAMES * 0.8 + 30.0) / 1.4)
    world = SyntheticWorld(n_points=16000, extent=extent, depth_range=(4.0, 80.0))
    return SyntheticDataset(num_frames=N_FRAMES, h=H, w=W, fx=FX, baseline=BASELINE_M,
                            trajectory="line", step=0.8, sensor_type=SensorType[sensor],
                            world=world)


def loop_stream():
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset, SyntheticWorld

    world = SyntheticWorld(n_points=16000, extent=30.0, depth_range=(4.0, 80.0))
    return SyntheticDataset(num_frames=LOOP_FRAMES, h=H, w=W, fx=FX, baseline=BASELINE_M,
                            trajectory="loop", period=LOOP_PERIOD,
                            sensor_type=SensorType.STEREO, world=world)


def render_loop_frames(first, last):
    """Frames [first, last) of the loop stream (a worker process)."""
    ds = loop_stream()
    return [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
            for i in range(first, last)]


def render_rgbd_frames(first, last):
    """Frames [first, last) of the main stage's stream as RGBD: (left,
    depth, timestamp) (a worker process)."""
    ds = bench_stream("RGBD")
    return [(ds.getImage(i), ds.getDepth(i), ds.getTimestamp(i)) for i in range(first, last)]


def render(fn, n):
    """fn's frames [0, n) rendered in chunks by up to 8 worker processes."""
    starts = range(0, n, RENDER_CHUNK)
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return [f for chunk in pool.map(fn, starts, [min(a + RENDER_CHUNK, n) for a in starts])
                for f in chunk]


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
    # matchers' distance matrices, and the aggregated SGM volume of the
    # integrator's depth (188x620, 32 disparities)
    # and the RANSAC's best hypothesis (argmax of 300 int64 inlier counts)
    for shape, dtypes in (((2000, 2000), (torch.int32, torch.float32)),
                          ((2000, 8192), (torch.int32, torch.float32)),
                          ((4, 2000, 2000), (torch.int32, torch.float32)),
                          ((188, 620, 32), (torch.int32, torch.float32)),
                          ((300,), (torch.int64, torch.int32))):
        for dtype in dtypes:
            keys = rng.integers(0, 4, shape)
            x = torch.as_tensor(keys).to(dev, dtype)
            for dim in (-1, -2)[:len(shape)]:
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


def build_integrator(cam, dev):
    """The TSDF integrator with its SGM depth provider, with the flags and
    factory arguments of bench.py:138-155."""
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.dense.volumetric_integrator import (
        VolumetricIntegratorType, volumetric_integrator_factory)

    Parameters.kVolumetricIntegrationUseDepthEstimator = True
    Parameters.kVolumetricIntegrationDepthEstimatorType = "sgbm"
    Parameters.kVolumetricIntegrationDepthTruncOutdoor = DEPTH_TRUNC_OUTDOOR
    return volumetric_integrator_factory(
        VolumetricIntegratorType.TSDF, camera=cam,
        environment_type=type("E", (), {"name": "OUTDOOR"})(),
        voxel_size=VOXEL_SIZE, sdf_trunc=SDF_TRUNC, device=dev)


def profile_call(fn):
    """Kernel launches and summed kernel time (ms) of one call of fn on the
    card, from torch.profiler (copies and fills not counted as launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))]
    return (sum(e.count for e in kernels),
            sum(e.self_device_time_total for e in kernels) / 1e3)


def events_ms(fn, n=20):
    """Time of one call of fn: CUDA events around n back-to-back calls after
    two warm-up calls, divided by n (where the host enqueues more slowly than
    the card runs, this is the host's time)."""
    import torch

    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(n_bytes, n_ops):
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_OPS_S * 1e3
    return dict(bytes=n_bytes, ops=n_ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def sgm_work(hs, ws, n_disp, tile=32, halo=16):
    """Bytes (two float32 images in, the disparity map out) and operations
    (OPS_* above) of sgm_disparity at hs x ws with n_disp disparities and the
    tiled aggregation's warm-up."""
    pixels = hs * ws
    paths = 0
    for S, T in ((ws, hs), (ws, hs), (hs, ws), (hs, ws)):
        paths += -(-S // tile) * T
    n_ops = (OPS_CENSUS * pixels + (OPS_COST + OPS_SUM4 + OPS_WTA) * pixels * n_disp
             + OPS_STEP * (halo + tile - 1) * paths * n_disp)
    return bound(3 * 4 * pixels, n_ops)


def keyframe_drops(vol, est, cam, left, right, Twc, insert=False):
    """(dropped, valid): the valid voxel updates of one keyframe (all its
    TSDF phases, depth from ``est``) and how many of them the table ``vol``
    drops, i.e. leaves unresolved after the insert's claim rounds.  The
    table is left as it stands, unless ``insert``: then each phase is fused
    into it as the integrator fuses it."""
    import torch

    from pyslam_tpu_torch.dense.tsdf import depth_to_voxel_updates
    from pyslam_tpu_torch.ops import voxel_hash

    dev = vol.device
    depth = est.infer_depth_device(left, right)
    inten = torch.as_tensor(np.asarray(left, np.float32), device=dev)
    K = torch.as_tensor(np.asarray(cam.K, np.float32), device=dev)
    T = torch.as_tensor(np.asarray(Twc, np.float32), device=dev)
    dropped = valid = 0
    for phase in range(TSDF_PHASES):
        upd = depth_to_voxel_updates(depth, inten, T, K, vol.voxel_size, vol.sdf_trunc,
                                     vol.depth_trunc, vol.stride, vol.band_steps, phase,
                                     TSDF_PHASES)
        slot, _ = voxel_hash.claim_slots(vol.table, upd[0], upd[4])
        dropped += int((upd[4] & (slot < 0)).sum())
        valid += int(upd[4].sum())
        if insert:
            vol.table = voxel_hash.insert_and_accumulate(vol.table, *upd)
    return dropped, valid


def dense_phase(dev, ds, cam, left, right):
    """Phase 6: the dense slice on the card against the CPU, and its times."""
    import torch

    from pyslam_tpu_torch.dense.tsdf import TSDFVolume, depth_to_voxel_updates
    from pyslam_tpu_torch.depth_estimation.depth_estimator import DepthEstimatorSgbm
    from pyslam_tpu_torch.ops import voxel_hash

    integ = build_integrator(cam, dev)
    est = integ._depth_provider
    assert isinstance(est, DepthEstimatorSgbm) and est.downscale == 2, est
    est_cpu = DepthEstimatorSgbm(cam, downscale=2, device="cpu")
    disp = est._disparity_full_scale(left, right)
    disp_cpu = est_cpu._disparity_full_scale(left, right)
    assert torch.equal(disp.cpu(), disp_cpu), "SGM disparity differs between card and CPU"
    depth = est.infer_depth_device(left, right)
    depth_cpu = est_cpu.infer_depth_device(left, right)
    assert depth.device == dev and torch.equal(depth.cpu(), depth_cpu), \
        "SGM depth differs between card and CPU"
    valid_share = float((depth > 0).float().mean())
    assert valid_share > 0.2, valid_share
    hs, ws = ds.h // 2, ds.w // 2
    n_disp = max(16, est.max_disparity // 2)
    log(f"[dense] SGM {hs}x{ws}x{n_disp} of the first stereo pair: disparity and depth "
        f"identical on the card and the CPU; {valid_share * 100:.2f}% of the pixels valid")

    # one keyframe's TSDF phases into a 1 << 22 table, card against CPU
    Twc = ds.poses[0]
    vols = [TSDFVolume(voxel_size=VOXEL_SIZE, sdf_trunc=SDF_TRUNC,
                       depth_trunc=DEPTH_TRUNC_OUTDOOR, capacity=TABLE_CAPACITY, device=d)
            for d in (dev, "cpu")]
    for phase in range(TSDF_PHASES):
        vols[0].integrate(depth, left, Twc, cam.K, phase=phase, phases=TSDF_PHASES)
        vols[1].integrate(depth_cpu, left, Twc, cam.K, phase=phase, phases=TSDF_PHASES)
    got, ref = vols[0].table, vols[1].table
    for f in ("keys", "occupied"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f)), f"TSDF {f} differ"
    max_err = {}
    for f in ("tsdf", "weight", "color"):
        a, b = getattr(got, f).cpu(), getattr(ref, f)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        max_err[f] = float((a - b).abs().max())
    n_vox = vols[0].num_voxels()
    assert n_vox > 0
    log(f"[dense] TSDF {TSDF_PHASES} phases (stride {vols[0].stride}, band "
        f"{vols[0].band_steps}) into a {TABLE_CAPACITY}-slot table: {n_vox} voxels, slots, "
        f"keys and occupied identical on the card and the CPU; max |card - CPU| "
        + ", ".join(f"{k} {v:.3g}" for k, v in max_err.items()))

    # times on the card: SGM a keyframe, one TSDF phase and its parts
    iml = torch.as_tensor(np.asarray(left, np.float32), device=dev)
    imr = torch.as_tensor(np.asarray(right, np.float32), device=dev)
    K = torch.as_tensor(np.asarray(cam.K, np.float32), device=dev)
    T = torch.as_tensor(np.asarray(Twc, np.float32), device=dev)
    inten = iml
    vol = vols[0]
    args = (VOXEL_SIZE, SDF_TRUNC, DEPTH_TRUNC_OUTDOOR, vol.stride, vol.band_steps)

    def sgm():
        return est.infer_depth_device(iml, imr)

    def updates(phase=1):
        return depth_to_voxel_updates(depth, inten, T, K, *args, phase, TSDF_PHASES)

    upd = updates()
    table0 = vol.table

    def insert():
        return voxel_hash.insert_and_accumulate(table0, *upd)

    def tsdf_phase():
        return voxel_hash.insert_and_accumulate(table0, *updates())

    out = {}
    for name, fn in (("sgm", sgm), ("tsdf_phase", tsdf_phase), ("updates", updates),
                     ("insert", insert)):
        fn()
        launches, dev_ms = profile_call(fn)
        out[name] = dict(launches=launches, device_ms=dev_ms, ms=events_ms(fn))
    # bounds: SGM from its shapes; the insert in place, from this phase's
    # updates and the table rows they touch
    # updates: the phase's strided pixels read, its updates written; the
    # phase fused: its pixels read and the rows it touches read and written
    # (no update batch in memory)
    sgm_b = sgm_work(hs, ws, n_disp)
    after = insert()
    touched = int(((after.weight != table0.weight) | (after.occupied != table0.occupied)).sum())
    n_upd = int(upd[0].shape[0])
    n_pix = n_upd // (2 * vol.band_steps + 1)
    out["sgm"].update(sgm_b)
    out["updates"].update(bound(PIXEL_BYTES * n_pix + UPDATE_BYTES * n_upd,
                                OPS_PIXEL * n_pix + OPS_UPDATE * n_upd), pixels=n_pix,
                          updates=n_upd)
    out["insert"].update(bound(UPDATE_BYTES * n_upd + 2 * ROW_BYTES * touched, 0),
                         updates=n_upd, valid_updates=int(upd[4].sum()),
                         touched_slots=touched)
    out["tsdf_phase"].update(bound(PIXEL_BYTES * n_pix + 2 * ROW_BYTES * touched,
                                   OPS_PIXEL * n_pix + OPS_UPDATE * n_upd),
                             parts_bound_ms=out["updates"]["bound_ms"]
                             + out["insert"]["bound_ms"])
    for name, o in out.items():
        log(f"[dense] {name}: {o['launches']} kernel launches, {o['device_ms']:.4f} ms of "
            f"kernel time a call (profiler), {o['ms']:.4f} ms a call over 20 back-to-back "
            f"calls (events)" + (f"; bound {o['bound_ms']:.5f} ms ({o['bound_by']}: "
                                  f"{o['bytes']} B, {o['ops']} operations)"
                                  if "bound_ms" in o else ""))

    # standalone TSDF rate as bench.py:158-177 measures it: whole 376x1241
    # random depths of 4-60 m from host arrays, after one warm-up integrate
    rng = np.random.default_rng(3)
    depths = [rng.uniform(4.0, 60.0, (ds.h, ds.w)).astype(np.float32) for _ in range(3)]
    inten_h = rng.uniform(0, 255, (ds.h, ds.w)).astype(np.float32)
    rate_vol = TSDFVolume(voxel_size=VOXEL_SIZE, sdf_trunc=SDF_TRUNC,
                          depth_trunc=DEPTH_TRUNC_OUTDOOR, capacity=TABLE_CAPACITY, device=dev)
    rate_vol.integrate(depths[0], inten_h, np.eye(4), cam.K)
    n_rate = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n_rate):
        rate_vol.integrate(depths[i % 3], inten_h, np.eye(4), cam.K)
    end.record()
    torch.cuda.synchronize()
    out["tsdf_rate_per_s"] = n_rate / (start.elapsed_time(end) / 1e3)
    log(f"[dense] standalone TSDF rate (stride {rate_vol.stride}, band "
        f"{rate_vol.band_steps}): {out['tsdf_rate_per_s']:.2f} integrations a second")
    log("[dense] " + json.dumps(out))
    return out


def ate_of(slam, gt_t, gt_p):
    """ATE (m) of the trajectory tracked so far against the ground truth."""
    from pyslam_tpu_torch.evaluation.metrics import eval_ate

    ts, Twc = slam.tracking.history.final_trajectory(slam.map)
    return float(eval_ate(ts, Twc[:, :3, 3], gt_t, gt_p, align=True, with_scale=False).rmse)


def loop_phase(dev, cam_args, frames):
    """Phase 8: bench.py's loop stage on the port; returns its fast_nms
    launches.  ``frames`` are the rendered (left, right, timestamp)."""
    import torch

    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops import optim
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    ds = loop_stream()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(LOOP_FRAMES)])
    gt_p = ds.poses[:LOOP_FRAMES, :3, 3]
    cam = PinholeCamera(*cam_args, fps=ds.fps, bf=ds.fx * ds.baseline, depth_threshold=35.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                loop_detector_config="DBOW3", sensor_type=SensorType.STEREO, device=dev)
    lc = slam.loop_closing
    events, pgo_args = [], []
    correct = lc.correct_loop
    pgo = optim.pose_graph_optimize

    def correct_loop(kf, cand, S12):
        before = ate_of(slam, gt_t, gt_p)
        correct(kf, cand, S12)
        events.append(dict(kf=kf.kid, cand=cand.kid, S12=S12.copy(),
                           geometry=dict(lc.last_geometry), ate_before=before,
                           ate_after=ate_of(slam, gt_t, gt_p), pgo=lc.last_pgo_size))

    def pose_graph_optimize(*args, **kw):
        pgo_args[:] = [args, kw]
        return pgo(*args, **kw)

    lc.correct_loop = correct_loop
    optim.pose_graph_optimize = pose_graph_optimize
    torch.cuda.synchronize()
    fast_nms.launches = 0
    lats = []
    t_start = time.perf_counter()
    for i, (img_l, img_r, ts) in enumerate(frames):
        nxt = None
        if i + 1 < LOOP_FRAMES:
            nl, nr, nts = frames[i + 1]
            nxt = {"img": nl, "img_right": nr, "frame_id": i + 1, "timestamp": nts}
        n_events = len(events)
        t1 = time.perf_counter()
        slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts, next_input=nxt)
        lats.append(time.perf_counter() - t1)
        if len(events) > n_events:
            e = events[-1]
            log(f"[loop] frame {i}: loop kf {e['kf']} <-> kf {e['cand']} closed in a "
                f"{lats[-1] * 1e3:.1f} ms frame; geometry {json.dumps(e['geometry'])}; PGO "
                f"{e['pgo'][0]} vertices, {e['pgo'][1]} edges; ATE so far {e['ate_before']:.4f}"
                f" m before the correction, {e['ate_after']:.4f} m after")
        elif i % 25 == 0:
            log(f"[loop] frame {i}: {lats[-1] * 1e3:.1f} ms, {slam.map.num_keyframes()} "
                f"keyframes, {slam.map.num_points()} points")
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = fast_nms.launches
    lc.correct_loop = correct
    optim.pose_graph_optimize = pgo
    n_tracked = len(slam.tracking.history.timestamps)
    ts_est, poses = slam.get_final_trajectory()
    ate = ate_of(slam, gt_t, gt_p)
    lat_ms = np.asarray(lats[LOOP_SKIP:]) * 1e3
    gba = slam.GBA
    log(f"[loop] {LOOP_FRAMES / wall:.2f} FPS over {LOOP_FRAMES} frames (incl. final drain), "
        f"latency p50 {np.percentile(lat_ms, 50):.1f} ms p95 {np.percentile(lat_ms, 95):.1f} ms"
        f" max {lat_ms.max():.1f} ms (frame {LOOP_SKIP + int(np.argmax(lat_ms))}) over frames "
        f"{LOOP_SKIP}-{LOOP_FRAMES - 1}; {lc.num_loops_closed} loops closed; "
        f"{n_tracked}/{LOOP_FRAMES} tracked; {slam.map.num_keyframes()} keyframes, "
        f"{slam.map.num_points()} points; ATE {ate:.4f} m; GBA {gba.runs_completed} applied, "
        f"{gba.runs_aborted} aborted (cost {gba.last_cost:.3f}); fast_nms launches {launches}")
    log("[loop] stage totals (ms, calls): " + json.dumps(
        {mod: {k: [round(v["total_ms"], 1), v["calls"]] for k, v in st.items()}
         for mod, st in slam.timings().items()
         if mod in ("loop_closing", "gba", "local_mapping")}))
    assert lc.num_loops_closed >= 1, "no loop closed"
    assert n_tracked == LOOP_FRAMES, f"{n_tracked}/{LOOP_FRAMES} tracked"
    assert np.isfinite(poses).all() and ate < ATE_MAX, ate
    assert gba.runs_completed >= 1, "no GBA applied"
    assert launches == LOOP_FRAMES, f"{launches} fast_nms launches for {LOOP_FRAMES} frames"
    assert slam.map.device.type == "cuda" and slam.map.device_store()[0].device.type == "cuda"

    # a lost frame relocalised on the card: frame RELOC_FRAME again, its
    # pose pushed 1 m away, against the final map; held to its tracked pose
    from pyslam_tpu_torch.slam.frame import Frame

    img_l, img_r, ts = frames[RELOC_FRAME]
    lost = Frame(cam, img_l, img_right=img_r, timestamp=ts,
                 feature_tracker=slam.feature_tracker, frame_id=10_000)
    Twc_tracked = poses[int(np.argmin(np.abs(ts_est - ts)))]
    push = np.eye(4)
    push[:3, 3] = [1.0, 0.0, 0.5]
    lost.update_pose(push @ np.linalg.inv(Twc_tracked))
    T_rel, ok_rel = lc.relocalizer.relocalize(lost, slam.map)
    err = float(np.linalg.norm(np.linalg.inv(T_rel)[:3, 3] - Twc_tracked[:3, 3]))
    log(f"[loop] frame {RELOC_FRAME} relocalised from a pose 1.1 m off: ok {ok_rel}, "
        f"{int((lost.points >= 0).sum())} points, {err:.4f} m from its tracked pose")
    assert ok_rel and err < 0.3, (ok_rel, err)

    # the loop event's device cost, replayed on the final map (its result
    # is not used further): geometry check, correction without its GBA, the
    # pose graph alone, the GBA's dispatch and one chunk
    e = events[0]
    kf, cand = slam.map.keyframes.get(e["kf"]), slam.map.keyframes.get(e["cand"])
    cost = {}
    if kf is not None and cand is not None:
        cost["geometry_check"] = profile_call(lambda: lc.geometry_check(kf, cand))
        dispatch = gba.dispatch
        gba.dispatch = lambda *a, **k: None
        cost["correct_loop_without_gba"] = profile_call(lambda: lc.correct_loop(kf, cand,
                                                                               e["S12"]))
        gba.dispatch = dispatch
    args, kw = pgo_args
    cost["pgo"] = profile_call(lambda: pgo(*args, **kw))
    cost["gba_dispatch"] = profile_call(lambda: gba.dispatch(slam.map))
    cost["gba_chunk"] = profile_call(lambda: gba.poll(block=True))
    gba.finish()
    log(f"[loop] loop event on the final map ({slam.map.num_keyframes()} keyframes, "
        f"{slam.map.num_points()} points), kernel launches and summed kernel time (ms, "
        f"torch.profiler): " + json.dumps({k: [n, round(ms, 4)] for k, (n, ms) in cost.items()}))
    return launches


def sensor_stage(dev, sensor, frames, cam, ds, integ=None):
    """Phases 9 and 10: the main stage's stream through Slam.track() as RGBD
    (left image and depth) or monocular (left image), with next-frame
    prefetch, then finish().  Returns the stage's numbers."""
    import torch

    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops import epipolar
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam

    mono = sensor == "MONOCULAR"
    tag = "[mono]" if mono else "[rgbd]"
    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType[sensor], device=dev)
    if integ is not None:
        slam.set_volumetric_integrator(integ)
    # record the initialiser's minimal samples (its default draws), so that
    # the initialising attempt can be replayed and profiled after the stage
    draws = []
    sample = epipolar.generator_sampler(dev, 42)

    def recording_sampler(*args):
        draws.append(sample(*args))
        return draws[-1]

    slam.tracking.initializer.sampler = recording_sampler
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_nms.launches = 0
    lats, init_frame, ref_frame, init_samples, t_start = [], None, None, None, None
    n = len(frames)
    for i, (img, depth, ts) in enumerate(frames):
        if i == 10:
            t_start = time.perf_counter()
        nxt = None
        if i + 1 < n:
            nxt = {"img": frames[i + 1][0], "frame_id": i + 1, "timestamp": frames[i + 1][2],
                   "depth": None if mono else frames[i + 1][1]}
        n_hist = len(slam.tracking.history.timestamps)
        t1 = time.perf_counter()
        slam.track(img, depth=None if mono else depth, frame_id=i, timestamp=ts,
                   next_input=nxt)
        lats.append(time.perf_counter() - t1)
        if init_frame is None and len(slam.tracking.history.timestamps) > n_hist:
            init_frame = i
            ref = slam.tracking.initializer.ref_frame
            ref_frame = ref.id if mono and ref is not None else i
            init_samples = draws[-1] if mono else None
            log(f"{tag} frame {i}: map initialised in a {lats[-1] * 1e3:.1f} ms frame, "
                f"{slam.map.num_keyframes()} keyframes, {slam.map.num_points()} points")
        if i % 10 == 0:
            log(f"{tag} frame {i}: {lats[-1] * 1e3:.1f} ms, {slam.map.num_keyframes()} "
                f"keyframes, {slam.map.num_points()} points")
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    out = dict(launches=fast_nms.launches, init_frame=init_frame, ref_frame=ref_frame,
               peak_mb=torch.cuda.max_memory_allocated() / 2**20,
               n_tracked=len(slam.tracking.history.timestamps),
               keyframes=slam.map.num_keyframes(), points=slam.map.num_points(),
               fps=(n - 10) / wall)
    ts_est, poses = slam.get_final_trajectory()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
    out["ate"] = float(eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:n, :3, 3],
                                align=True, with_scale=mono).rmse)
    lat_ms = np.asarray(lats[10:]) * 1e3
    out["p50_ms"], out["p95_ms"] = np.percentile(lat_ms, 50), np.percentile(lat_ms, 95)
    out["init_frame_ms"] = lats[init_frame] * 1e3 if init_frame is not None else None
    log(f"{tag} {out['fps']:.2f} FPS over frames 10-{n - 1} (incl. final drain), latency "
        f"p50 {out['p50_ms']:.1f} ms p95 {out['p95_ms']:.1f} ms; initialised at frame "
        f"{init_frame}; {out['n_tracked']}/{n} tracked, {out['keyframes']} keyframes, "
        f"{out['points']} points, {slam.local_mapping.lba_applied} local BAs applied, ATE "
        f"{out['ate']:.4f} m{' (similarity alignment)' if mono else ''}; fast_nms launches "
        f"{out['launches']}; peak device memory {out['peak_mb']:.1f} MiB")
    if integ is not None:
        n_vox = integ.volume.num_voxels()
        out.update(snapshots=len(integ.snapshots), integrated=integ.volume.num_integrated,
                   voxels=n_vox, load=n_vox / integ.volume.capacity)
        log(f"{tag} dense (sensor depth, no SGM): {out['snapshots']} keyframes handed over, "
            f"{out['integrated']} integrated, {n_vox} voxels, load factor {out['load']:.4f}")
    log(f"{tag} stage totals: " + json.dumps(
        {mod: {k: round(v["total_ms"], 1) for k, v in st.items()}
         for mod, st in slam.timings().items()}))
    assert slam.map.device.type == "cuda"
    return out, slam, init_samples


def vo_phase(dev, frames, cam, ds):
    """Phase 11: both visual odometries on the stream, each frame timed on
    the host; returns their numbers."""
    import torch

    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
    from pyslam_tpu_torch.io.ground_truth import groundtruth_factory
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.visual_odometry import VisualOdometry
    from pyslam_tpu_torch.slam.visual_odometry_rgbd import VisualOdometryRgbd

    n = len(frames)
    gt = groundtruth_factory({"type": "synthetic", "dataset": ds})
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=N_FEATURES,
                                                           num_levels=N_LEVELS), device=dev)
    out = {}
    for name, vo in (("mono", VisualOdometry(cam, tracker, groundtruth=gt)),
                     ("rgbd", VisualOdometryRgbd(cam, num_features=N_FEATURES, device=dev))):
        torch.cuda.synchronize()
        fast_nms.launches = 0
        lats = []
        t0 = time.perf_counter()
        for i, (img, depth, ts) in enumerate(frames):
            t1 = time.perf_counter()
            if name == "mono":
                vo.track(img, i, ts)
            else:
                vo.track(img, depth, i, ts)
            lats.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ate = float(eval_ate(np.asarray(vo.timestamps), vo.trajectory, gt.timestamps,
                             gt.positions[:n], align=True, with_scale=False).rmse)
        out[name] = dict(launches=fast_nms.launches, fps=n / wall, ate=ate,
                         p50_ms=float(np.percentile(np.asarray(lats[1:]) * 1e3, 50)), vo=vo)
        log(f"[vo] {name}: {out[name]['fps']:.2f} FPS over {n} frames, latency p50 "
            f"{out[name]['p50_ms']:.1f} ms, ATE {ate:.4f} m, fast_nms launches "
            f"{out[name]['launches']}")
    return out, tracker


def card_vs_cpu(dev, frames, cam, tracker):
    """Phase 11's comparisons on one frame pair, card against CPU: the RGBD
    virtual right coordinates, the essential matrix and pose with the same
    minimal samples, LK; and the device cost (launches, kernel ms) of one LK
    call at 2000 points and one find_essential + recover_pose."""
    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.ops import epipolar, fast, lk, nms
    from pyslam_tpu_torch.slam.frame import Frame, compute_stereo_from_rgbd
    from pyslam_tpu_torch.utils.padding import pad_bucket, pad_rows

    (img0, depth0, _), (img1, _, _) = frames[0], frames[1]
    f0 = Frame(cam, img0, depth=depth0, feature_tracker=tracker, frame_id=0)
    cpu = torch.device("cpu")
    kps, raw, valid = f0.dev("kps"), torch.as_tensor(f0.kps_raw).to(dev), f0.dev("valid")
    d0 = torch.as_tensor(depth0).to(dev)
    got = compute_stereo_from_rgbd(kps, raw, valid, d0, cam.bf, Parameters.kMinDepth)
    ref = compute_stereo_from_rgbd(kps.to(cpu), raw.to(cpu), valid.to(cpu), d0.to(cpu), cam.bf,
                                   Parameters.kMinDepth)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b), "compute_stereo_from_rgbd differs on the card"
    log(f"[card-cpu] compute_stereo_from_rgbd identical on the card and the CPU "
        f"({int((got[1] > 0).sum())} keypoints with depth)")

    # the essential matrix of the monocular pair 0 -> 1, the same samples
    fa, fb = tracker.detectAndCompute(img0), tracker.detectAndCompute(img1)
    i1, i2 = tracker.match(fa, fb)
    xa, xb = fa.xy.cpu().numpy()[i1], fb.xy.cpu().numpy()[i2]
    xy1, pvalid = pad_bucket(np.asarray(cam.unproject_points(xa)))
    xy2 = pad_rows(np.asarray(cam.unproject_points(xb)), len(pvalid))
    th2 = (1.0 / cam.fx) ** 2 * 3.84
    samples = epipolar.generator_sampler(cpu, 42)(torch.as_tensor(pvalid), 512, 8)
    res = {}
    for d in (dev, cpu):
        x1, x2 = torch.as_tensor(xy1).to(d), torch.as_tensor(xy2).to(d)
        E, m, nin = epipolar.find_essential(x1, x2, torch.as_tensor(pvalid).to(d), th2, 512,
                                            samples=samples.to(d))
        T, front = epipolar.recover_pose(E, x1, x2, m)
        res[d.type] = (E.cpu().numpy(), m.cpu().numpy(), int(nin), T.cpu().numpy(),
                       front.cpu().numpy())
    (Eg, mg, ng, Tg, _), (Ec, mc, nc, Tc, _) = res["cuda"], res["cpu"]
    rot = float(np.arccos(np.clip((np.trace(Tg[:3, :3].T @ Tc[:3, :3]) - 1) / 2, -1, 1)))
    tdir = float(np.linalg.norm(Tg[:3, 3] / np.linalg.norm(Tg[:3, 3])
                                - Tc[:3, 3] / np.linalg.norm(Tc[:3, 3])))
    # recover_pose of the same E on both
    x1g, x2g = torch.as_tensor(xy1).to(dev), torch.as_tensor(xy2).to(dev)
    Tsame, fsame = epipolar.recover_pose(torch.as_tensor(Ec).to(dev), x1g, x2g,
                                         torch.as_tensor(mc).to(dev))
    Tsame = Tsame.cpu().numpy()
    rot_same = float(np.arccos(np.clip((np.trace(Tsame[:3, :3].T @ Tc[:3, :3]) - 1) / 2,
                                       -1, 1)))
    log(f"[card-cpu] find_essential + recover_pose on {len(i1)} matches of frames 0-1, the "
        f"same 512 minimal samples: inliers {ng} on the card, {nc} on the CPU; rotation "
        f"{rot:.3e} rad and unit translation {tdir:.3e} apart; recover_pose of the CPU's E "
        f"on the card: rotation {rot_same:.3e} rad apart, in-front mask "
        f"{'identical' if np.array_equal(fsame.cpu().numpy(), res['cpu'][4]) else 'differs'}")
    # per hypothesis: the solvers take AᵀA's null vector in float32, which
    # is float32 noise where λ2 / λmax <= 1e-5 (float64); count how many of
    # the 512 hypotheses are above that line and how their inlier counts
    # compare (reported: on this forward-moving pair nearly none are)
    counts = {}
    for d in (dev, cpu):
        x1, x2 = torch.as_tensor(xy1).to(d), torch.as_tensor(xy2).to(d)
        Es = epipolar._eight_point(x1[samples.to(d)], x2[samples.to(d)])
        counts[d.type] = torch.sum((epipolar._sampson_error(Es, x1, x2) < th2)
                                   & torch.as_tensor(pvalid).to(d)[None], 1).cpu().numpy()
    A = epipolar._epipolar_rows(torch.as_tensor(xy1).double()[samples],
                                torch.as_tensor(xy2).double()[samples])
    lam = torch.linalg.eigvalsh(A.transpose(-1, -2) @ A).numpy()
    good = lam[:, 1] / lam[:, -1] > 1e-5
    hyp_diff = int(np.abs(counts["cuda"] - counts["cpu"])[good].max()) if good.any() else None
    n_same = int((counts["cuda"] == counts["cpu"]).sum())
    log(f"[card-cpu] hypotheses: {int(good.sum())} of 512 well-conditioned (their inlier "
        f"counts at most {hyp_diff} apart); {n_same} of 512 with identical inlier counts")
    assert abs(ng - nc) <= 0.1 * len(i1) and rot <= 2e-2 and tdir <= 0.3, (ng, nc, rot, tdir)
    assert rot_same <= 1e-3, rot_same

    # LK of the RGBD VO's corners, 2000 at most, frame 0 -> 1
    score = fast.fast_nms(torch.as_tensor(img0)[None].to(dev), VO_FAST_TH)
    xy, _, v = nms.grid_topk_keypoints(score, 16, 6, N_FEATURES)
    pts = xy[0][v[0]].cpu().numpy()
    ptsp, _ = pad_bucket(pts.astype(np.float32))
    out = {}
    for d in (dev, cpu):
        p, ok, _ = lk.lk_track_pyramidal(torch.as_tensor(img0).to(d), torch.as_tensor(img1).to(d),
                                         torch.as_tensor(ptsp).to(d))
        out[d.type] = (p.cpu().numpy(), ok.cpu().numpy())
    both = out["cuda"][1] & out["cpu"][1]
    lk_err = float(np.abs(out["cuda"][0][both] - out["cpu"][0][both]).max())
    n_ok_diff = int((out["cuda"][1] != out["cpu"][1]).sum())
    log(f"[card-cpu] LK of {len(pts)} corners (padded to {len(ptsp)}): {int(both.sum())} ok on "
        f"both, max |card - CPU| {lk_err:.3e} px, ok masks differ on {n_ok_diff}")
    assert lk_err <= 1e-2, lk_err

    # device cost of one LK call and one essential matrix + pose
    i0t, i1t = torch.as_tensor(img0).to(dev), torch.as_tensor(img1).to(dev)
    pt = torch.as_tensor(ptsp).to(dev)
    vt = torch.as_tensor(pvalid).to(dev)
    st = samples.to(dev)

    def essential():
        E, m, _ = epipolar.find_essential(x1g, x2g, vt, th2, 512, samples=st)
        return epipolar.recover_pose(E, x1g, x2g, m)

    cost = {"lk_track_pyramidal": profile_call(lambda: lk.lk_track_pyramidal(i0t, i1t, pt)),
            "find_essential_recover_pose": profile_call(essential)}
    cost_ms = {"lk_track_pyramidal": events_ms(lambda: lk.lk_track_pyramidal(i0t, i1t, pt), 5),
               "find_essential_recover_pose": events_ms(essential, 5)}
    log(f"[cost] kernel launches and summed kernel time (ms, torch.profiler), and the time "
        f"of one call (ms, CUDA events over 5 calls): LK at {len(ptsp)} points "
        f"{cost['lk_track_pyramidal']}, {cost_ms['lk_track_pyramidal']:.3f} ms; "
        f"find_essential + recover_pose at {len(pvalid)} rows "
        f"{cost['find_essential_recover_pose']}, "
        f"{cost_ms['find_essential_recover_pose']:.3f} ms")
    return dict(lk_err=lk_err, rot=rot, tdir=tdir, rot_same_E=rot_same,
                hyp_well_conditioned=int(good.sum()), hyp_diff=hyp_diff,
                hyp_identical=n_same, inliers=(ng, nc), cost=cost, cost_ms=cost_ms)


def mono_init_cost(dev, frames, cam, tracker, ref_id, init_id, samples):
    """Launches and kernel ms of the monocular initialisation of phase 10,
    replayed: frame ref_id as the reference, frame init_id's attempt
    profiled with the minimal samples that attempt drew in the stage."""
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.frame import Frame
    from pyslam_tpu_torch.slam.initializer import Initializer
    from pyslam_tpu_torch.slam.map import Map

    fr = Frame(cam, frames[ref_id][0], feature_tracker=tracker, frame_id=ref_id)
    fi = Frame(cam, frames[init_id][0], feature_tracker=tracker, frame_id=init_id)
    init = Initializer(SensorType.MONOCULAR, N_FEATURES, device=dev,
                       sampler=lambda *args: samples)
    m = Map(device=dev)
    init.initialize(fr, m)
    result = []
    cost = profile_call(lambda: result.append(init.initialize(fi, m).success))
    log(f"[cost] the monocular initialisation of phase 10 replayed (reference frame "
        f"{ref_id}, frame {init_id}, its minimal samples): {cost[0]} kernel launches, "
        f"{cost[1]:.4f} ms of kernel time; success {result[0]}")
    return cost


def one_image_kernels(dev, frames):
    """The kernel as the monocular and RGBD paths call it, against its
    plain version, bit for bit, and timed: the B = 1 pyramid (8 levels of
    one 376x1241 image at threshold 20) and the RGBD VO's one level at
    threshold 15."""
    import torch

    from pyslam_tpu_torch.ops import image as image_ops
    from pyslam_tpu_torch.ops.fast import fast_nms, fast_nms_plain, fast_nms_pyramid

    img = torch.as_tensor(frames[0][0])[None].to(dev)
    levels = [x.contiguous() for x in image_ops.build_pyramid(img, N_LEVELS, 1.2)]
    out = {}
    for name, fn, plain, lv, th in (
            ("b1_pyramid", lambda: fast_nms_pyramid(levels, FAST_TH),
             lambda: [fast_nms_plain(x, FAST_TH) for x in levels], levels, FAST_TH),
            ("vo_level_th15", lambda: [fast_nms(img, VO_FAST_TH)],
             lambda: [fast_nms_plain(img, VO_FAST_TH)], [img], VO_FAST_TH)):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b), f"fast_nms differs from the plain version ({name})"
        work = fast_work(lv, th, BORDER)
        out[name] = dict(ms=statistics.median([graph_ms(fn), graph_ms(fn)]),
                         plain_ms=median_ms(plain, n=10), bound_ms=work["bound_ms"],
                         bound_by=work["bound_by"], max_abs_err=max(
                             float((a - b).abs().max()) for a, b in zip(got, ref)))
        log(f"[kernel] fast_nms {name}: equal to the plain version; {out[name]['ms']:.4f} ms "
            f"(CUDA-graph replays), plain {out[name]['plain_ms']:.4f} ms, bound "
            f"{work['bound_ms']:.5f} ms ({work['bound_by']}), "
            f"{work['bound_ms'] / out[name]['ms'] * 100:.1f}% of it")
    return out


def preset_session(dev, preset, frames, cam, ds, loop=None):
    """Phase 12: a stereo session of ``preset`` (at the preset's own width)
    with the ``loop`` detector, next-frame prefetch, then finish(); the
    descriptor gates that Slam writes into Parameters are restored.
    Returns the session's numbers."""
    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam

    gates = {k: getattr(Parameters, k) for k in ("kMaxDescriptorDistance",
                                                 "kMaxOrbDistanceSearchByReproj")}
    tag = f"[features] {preset}"
    try:
        slam = Slam(cam, preset, loop_detector_config=loop, sensor_type=SensorType.STEREO,
                    device=dev)
        resets = []
        reset = slam.reset

        def counted_reset():
            resets.append(i)
            reset()

        slam.reset = counted_reset
        torch.cuda.synchronize()
        fast_nms.launches = 0
        lats, t_start, n = [], None, len(frames)
        for i, (img_l, img_r, ts) in enumerate(frames):
            if i == 10:
                t_start = time.perf_counter()
            nxt = None
            if i + 1 < n:
                nl, nr, nts = frames[i + 1]
                nxt = {"img": nl, "img_right": nr, "frame_id": i + 1, "timestamp": nts}
            t1 = time.perf_counter()
            slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts, next_input=nxt)
            lats.append(time.perf_counter() - t1)
            if i % 10 == 0:
                log(f"{tag} frame {i}: {lats[-1] * 1e3:.1f} ms, {slam.map.num_keyframes()} "
                    f"keyframes, {slam.map.num_points()} points")
        slam.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        ts_est, poses = slam.get_final_trajectory()
        gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
        lat_ms = np.asarray(lats[10:]) * 1e3
        out = dict(preset=preset, loop=loop, launches=fast_nms.launches, resets=len(resets),
                   n_tracked=len(slam.tracking.history.timestamps),
                   keyframes=slam.map.num_keyframes(), points=slam.map.num_points(),
                   desc=f"{slam.map.points.desc.shape[1]}x{slam.map.points.desc.dtype}",
                   fps=(n - 10) / wall, p50_ms=float(np.percentile(lat_ms, 50)),
                   p95_ms=float(np.percentile(lat_ms, 95)),
                   ate=(float(eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:n, :3, 3],
                                       align=True, with_scale=False).rmse)
                        if len(ts_est) >= 3 else float("nan")))
        assert slam.map.device.type == torch.device(dev).type
        log(f"{tag} loop={loop}: {out['fps']:.2f} FPS over frames 10-{n - 1} (incl. final "
            f"drain), latency p50 {out['p50_ms']:.1f} ms p95 {out['p95_ms']:.1f} ms; "
            f"{out['n_tracked']}/{n} tracked, {out['resets']} resets, {out['keyframes']} "
            f"keyframes, {out['points']} points ({out['desc']} descriptors), ATE "
            f"{out['ate']:.4f} m; fast_nms launches {out['launches']}")
        log(f"{tag} stage totals: " + json.dumps(
            {mod: {k: round(v["total_ms"], 1) for k, v in st.items()}
             for mod, st in slam.timings().items()}))
        del slam
        torch.cuda.empty_cache()
        return out
    finally:
        for k, v in gates.items():
            setattr(Parameters, k, v)


def kaze_card_vs_cpu(dev, frames):
    """Phase 12c: KAZE on frames 0-1, card against CPU: keypoints,
    descriptors, the L2 brute-force matches and the float flat
    vocabulary's words."""
    import torch

    from pyslam_tpu_torch.features.tracker import feature_tracker_factory
    from pyslam_tpu_torch.loop_closing.vocabulary import BinaryVocabulary

    trackers = [feature_tracker_factory("KAZE", device=d) for d in (dev, "cpu")]
    feats = [[tr.detectAndCompute(frames[i][0]) for i in (0, 1)] for tr in trackers]
    torch.cuda.synchronize()
    g0, c0 = [[x.cpu().numpy() for x in f[0]] for f in feats]
    names = feats[0][0]._fields
    for name in ("xy", "valid", "level", "response", "size"):
        a, b = g0[names.index(name)], c0[names.index(name)]
        assert np.array_equal(a, b), f"KAZE {name} differs on the card"
    desc_err = float(np.abs(g0[names.index("desc")] - c0[names.index("desc")]).max())
    ang = np.abs((g0[names.index("angle")] - c0[names.index("angle")] + 180.0) % 360.0 - 180.0)
    assert desc_err <= KAZE_DESC_TOL, desc_err
    matches = [tr.match(f[0], f[1]) for tr, f in zip(trackers, feats)]
    for a, b in zip(matches[0], matches[1]):
        assert np.array_equal(a, b), "KAZE L2 matches differ on the card"
    # the flat float vocabulary of DBOW3_INDEPENDENT on each device, seeded
    # and trained from the same host descriptors, quantising each device's
    seed = c0[names.index("desc")][c0[names.index("valid")]]
    both = np.concatenate([f.desc[f.valid].cpu().numpy() for f in feats[1]])
    vocs = [BinaryVocabulary(num_words=4096, device=d) for d in (dev, "cpu")]
    words = []
    for voc, f in zip(vocs, feats):
        voc.seed_from_descriptors(seed)
        voc.train_kmeans(both)
        words.append([voc.words_for(x.desc, x.valid) for x in f])
    cent_err = float(np.abs(vocs[0].words_bits - vocs[1].words_bits).max())
    for a, b in zip(words[0], words[1]):
        assert np.array_equal(a, b), "float vocabulary words differ on the card"
    out = dict(keypoints=int(g0[names.index("valid")].sum()), desc_max_abs_err=desc_err,
               angle_max_deg=float(ang.max()), matches=int(len(matches[0][0])),
               centroid_max_abs_err=cent_err,
               distinct_words=int(len(np.unique(np.concatenate(words[0])))))
    log(f"[features] KAZE card against CPU, frames 0-1: {out['keypoints']} keypoints, xy / "
        f"valid / level / response / size identical; descriptors within {desc_err:.3g} "
        f"(tolerance {KAZE_DESC_TOL}), angles within {out['angle_max_deg']:.3g} deg; "
        f"{out['matches']} L2 brute-force matches identical; the float vocabulary's "
        f"centroids within {cent_err:.3g}, words of both frames identical "
        f"({out['distinct_words']} distinct)")
    return out


def presets_on_card(dev, img):
    """Every weight-free preset built on the card through the factory, each
    extracting ``img``: valid keypoints and descriptor layout by preset."""
    import torch

    from pyslam_tpu_torch.features.tracker import WEIGHT_FREE_PRESETS, feature_tracker_factory

    out = {}
    for name in WEIGHT_FREE_PRESETS:
        if name in ("SIFT", "ROOT_SIFT"):
            try:
                import cv2  # noqa: F401
            except ImportError:
                continue
        fd = feature_tracker_factory(name, device=dev).detectAndCompute(img)
        assert fd.desc.device.type == fd.xy.device.type == torch.device(dev).type, name
        out[name] = f"{int(fd.valid.sum())} x {fd.desc.shape[1]} {str(fd.desc.dtype)[6:]}"
    log("[features] every weight-free preset built on the card, frame 0 extracted "
        "(valid keypoints x descriptor layout): " + json.dumps(out))
    return out


def features_phase(dev, frames, cam, ds):
    """Phase 12: the weight-free presets' sessions; returns their numbers."""
    out = {"sessions": [], "presets": presets_on_card(dev, frames[0][0])}
    beblid = preset_session(dev, "ORB2_BEBLID", frames, cam, ds, loop="DBOW3_INDEPENDENT")
    n = len(frames)
    assert beblid["launches"] == n, f"{beblid['launches']} fast_nms launches for {n} frames"
    assert beblid["n_tracked"] == n, f"ORB2_BEBLID {beblid['n_tracked']}/{n} tracked"
    assert beblid["ate"] < FEATURE_ATE_MAX and beblid["desc"] == "512xint8", beblid
    out["ORB2_BEBLID"] = beblid
    out["sessions"].append("ORB2_BEBLID+DBOW3_INDEPENDENT")
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    out["cv2"] = has_cv2
    if has_cv2:
        sift = preset_session(dev, "ROOT_SIFT", frames, cam, ds, loop="DBOW3_INDEPENDENT")
        assert sift["n_tracked"] == n, f"ROOT_SIFT {sift['n_tracked']}/{n} tracked"
        assert sift["ate"] < FEATURE_ATE_MAX and sift["desc"] == "128xfloat32", sift
        out["ROOT_SIFT"] = sift
        out["sessions"].append("ROOT_SIFT+DBOW3_INDEPENDENT")
    else:
        print("[features] cv2 not importable: ROOT_SIFT session not run", flush=True)
    out["kaze_card_vs_cpu"] = kaze_card_vs_cpu(dev, frames)
    out["sessions"].append("KAZE card-vs-CPU")
    kaze = preset_session(dev, "KAZE", frames[:KAZE_FRAMES], cam, ds)
    assert kaze["desc"] in ("64xfloat32", "256xint8"), kaze
    out["KAZE"] = kaze
    out["sessions"].append("KAZE")
    log(f"[features] KAZE {KAZE_FRAMES} frames on the card: {kaze['n_tracked']} tracked, "
        f"{kaze['resets']} resets; the JAX package on the CPU: {WITNESS_KAZE[0]} tracked, "
        f"{WITNESS_KAZE[1]} resets")
    return out


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
    from pyslam_tpu_torch.ops.voxel_hash import INSERT_ROUNDS
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
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=35.0)
    dense_phase(dev, ds, cam, left0, right0)

    # ---------------------------------------------------------------- 7
    t0 = time.perf_counter()
    frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
              for i in range(N_FRAMES)]
    log(f"[main] rendered {N_FRAMES} stereo frames {H}x{W} in "
        f"{time.perf_counter() - t0:.1f} s")
    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType.STEREO, device=dev)
    integ = build_integrator(cam, dev)
    slam.set_volumetric_integrator(integ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
                f"{slam.map.num_keyframes()} keyframes, {slam.map.num_points()} points, "
                f"{integ.volume.num_voxels()} voxels")
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = fast_nms.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n_tracked = len(slam.tracking.history.timestamps)
    ts_est, poses = slam.get_final_trajectory()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(N_FRAMES)])
    ate = eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:, :3, 3], align=True,
                   with_scale=False).rmse
    lat_ms = np.asarray(lats[10:]) * 1e3
    n_kfs = slam.map.num_keyframes()
    n_lba = slam.local_mapping.lba_applied
    n_vox = integ.volume.num_voxels()
    load = n_vox / integ.volume.capacity
    n_snap = len(integ.snapshots)
    log(f"[main] {(N_FRAMES - 10) / wall:.2f} FPS over frames 10-{N_FRAMES - 1} (incl. final "
        f"drain), latency p50 {np.percentile(lat_ms, 50):.1f} ms p95 "
        f"{np.percentile(lat_ms, 95):.1f} ms; {n_tracked}/{N_FRAMES} tracked, {n_kfs} "
        f"keyframes, {slam.map.num_points()} points, {n_lba} local BAs applied, "
        f"ATE {ate:.4f} m; fast_nms launches {launches}")
    dropped, valid = keyframe_drops(integ.volume, integ._depth_provider, cam, frames[-1][0],
                                    frames[-1][1], ds.poses[N_FRAMES - 1])
    drop = dropped / max(valid, 1)
    log(f"[main] dense: {n_snap} keyframes handed over, {integ.volume.num_integrated} "
        f"integrated, {n_vox} voxels, load factor {load:.4f} (ceiling {LOAD_MAX}; the "
        f"capacity flag's sizing rule is <= 0.25: {'kept' if load <= 0.25 else 'exceeded'}); "
        f"a keyframe of the last frame would leave {dropped} of its {valid} valid updates "
        f"({drop * 100:.3f}%, ceiling {DROP_MAX * 100:.0f}%) unresolved after the "
        f"{INSERT_ROUNDS} claim rounds (dropped); peak device memory {peak_mb:.1f} MiB "
        f"(torch.cuda.max_memory_allocated)")
    log("[main] stage totals: " + json.dumps(
        {mod: {k: round(v["total_ms"], 1) for k, v in st.items()}
         for mod, st in slam.timings().items()}))
    assert launches == N_FRAMES, f"{launches} fast_nms launches for {N_FRAMES} frames"
    assert n_kfs >= 2 and n_lba >= 1, (n_kfs, n_lba)
    assert n_tracked == N_FRAMES, f"{n_tracked}/{N_FRAMES} tracked"
    assert np.isfinite(poses).all() and ate < ATE_MAX, ate
    assert n_snap >= 1 and integ.volume.num_integrated == n_snap, \
        (n_snap, integ.volume.num_integrated)
    assert n_vox > 0, n_vox
    assert load <= LOAD_MAX and drop <= DROP_MAX, (load, drop)
    assert integ.volume.table.tsdf.device.type == "cuda"
    del slam, integ
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 8
    t0 = time.perf_counter()
    loop_frames = render(render_loop_frames, LOOP_FRAMES)
    log(f"[loop] rendered {LOOP_FRAMES} stereo frames {H}x{W} in "
        f"{time.perf_counter() - t0:.1f} s (worker processes)")
    loop_launches = loop_phase(dev, (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy), loop_frames)
    del loop_frames
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 9
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.dense.volumetric_integrator import (
        VolumetricIntegratorType, volumetric_integrator_factory)

    t0 = time.perf_counter()
    rgbd_frames = render(render_rgbd_frames, N_FRAMES)
    log(f"[rgbd] rendered {N_FRAMES} frames {H}x{W} with depth in "
        f"{time.perf_counter() - t0:.1f} s (worker processes)")
    ds_rgbd = bench_stream("RGBD")
    cam_rgbd = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                             bf=ds.fx * BASELINE_M, depth_threshold=35.0)
    # the TSDF integrator on the sensor's depth: no estimator, the main
    # stage's voxel, truncation and table
    Parameters.kVolumetricIntegrationUseDepthEstimator = False
    Parameters.kVolumetricIntegrationDepthTruncOutdoor = DEPTH_TRUNC_OUTDOOR
    integ = volumetric_integrator_factory(
        VolumetricIntegratorType.TSDF, camera=cam_rgbd,
        environment_type=type("E", (), {"name": "OUTDOOR"})(),
        voxel_size=VOXEL_SIZE, sdf_trunc=SDF_TRUNC, device=dev)
    assert integ._depth_provider is None and integ.volume.capacity == TABLE_CAPACITY
    rgbd, slam, _ = sensor_stage(dev, "RGBD", rgbd_frames, cam_rgbd, ds_rgbd, integ)
    assert rgbd["launches"] == N_FRAMES, f"{rgbd['launches']} fast_nms launches"
    assert rgbd["n_tracked"] == N_FRAMES, f"{rgbd['n_tracked']}/{N_FRAMES} tracked"
    assert rgbd["ate"] < ATE_MAX, rgbd["ate"]
    assert rgbd["snapshots"] >= 1 and rgbd["integrated"] == rgbd["snapshots"], rgbd
    assert rgbd["voxels"] > 0 and integ.volume.table.tsdf.device.type == "cuda"
    del slam, integ
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 10
    ds_mono = bench_stream("MONOCULAR")
    cam_mono = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                             depth_threshold=35.0)
    mono_frames = [(img, None, ts) for img, _, ts in rgbd_frames]
    mono, slam, init_samples = sensor_stage(dev, "MONOCULAR", mono_frames, cam_mono, ds_mono)
    init_frame = mono["init_frame"]
    assert init_frame is not None and init_frame <= MONO_REF_INIT_FRAME + MONO_INIT_MARGIN, \
        f"initialised at frame {init_frame}, the reference at {MONO_REF_INIT_FRAME}"
    assert mono["n_tracked"] == N_FRAMES - init_frame, \
        f"{mono['n_tracked']} tracked from frame {init_frame} on"
    assert mono["launches"] == N_FRAMES, f"{mono['launches']} fast_nms launches"
    assert mono["ate"] < ATE_MAX, mono["ate"]
    del slam
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 11
    vo, tracker = vo_phase(dev, rgbd_frames, cam_mono, ds_rgbd)
    assert vo["mono"]["launches"] == N_FRAMES and vo["rgbd"]["launches"] == N_FRAMES, \
        {k: v["launches"] for k, v in vo.items()}
    assert vo["mono"]["ate"] < VO_MONO_ATE_MAX and vo["rgbd"]["ate"] < VO_RGBD_ATE_MAX, \
        {k: v["ate"] for k, v in vo.items()}
    card = card_vs_cpu(dev, rgbd_frames, cam_rgbd, tracker)
    init_cost = mono_init_cost(dev, mono_frames, cam_mono, tracker, mono["ref_frame"],
                               init_frame, init_samples)
    one = one_image_kernels(dev, rgbd_frames)
    log("[sensors] " + json.dumps({
        "rgbd": {k: v for k, v in rgbd.items()},
        "mono": {k: v for k, v in mono.items()},
        "vo": {k: {kk: vv for kk, vv in v.items() if kk != "vo"} for k, v in vo.items()},
        "card_vs_cpu": card, "mono_init_cost": init_cost, "kernel_calls": one},
        default=float))

    # ---------------------------------------------------------------- 12
    feats = features_phase(dev, frames, cam, ds)
    print(json.dumps({"features": feats}, default=float), flush=True)

    print(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda",
        "source": "pyslam_tpu_torch/csrc/fast_nms.cu",
        "replaces": "pyslam_tpu/ops/pallas_fast.py:95",
        "launches": launches, "launches_per_frame": launches / N_FRAMES,
        "launches_loop_stage": loop_launches,
        "launches_rgbd_stage": rgbd["launches"], "launches_mono_stage": mono["launches"],
        "launches_vo_mono": vo["mono"]["launches"], "launches_vo_rgbd": vo["rgbd"]["launches"],
        "launches_beblid_stage": feats["ORB2_BEBLID"]["launches"],
        "mono_frame": one["b1_pyramid"], "vo_rgbd_level_th15": one["vo_level_th15"],
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
