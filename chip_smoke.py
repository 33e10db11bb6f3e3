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
     device memory.
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
    # matchers' distance matrices, and the aggregated SGM volume of the
    # integrator's depth (188x620, 32 disparities)
    for shape in ((2000, 2000), (2000, 8192), (4, 2000, 2000), (188, 620, 32)):
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
    assert n_tracked >= 0.9 * N_FRAMES, n_tracked
    assert np.isfinite(poses).all() and ate < ATE_MAX, ate
    assert n_snap >= 1 and integ.volume.num_integrated == n_snap, \
        (n_snap, integ.volume.num_integrated)
    assert n_vox > 0, n_vox
    assert load <= LOAD_MAX and drop <= DROP_MAX, (load, drop)
    assert integ.volume.table.tsdf.device.type == "cuda"

    # ---------------------------------------------------------------- 8
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
