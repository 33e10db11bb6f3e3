"""Where the float32 global BA places weakly held points, in the JAX package
and in the port, on one problem.

    python -m tests.torch_gba_placement [--frames 60] [--iters 10] [--out DIR]
    python -m tests.torch_gba_placement --map STATE/map.json [--device cuda]

Runs the port's stereo ``Slam`` on the CPU over the main stage's stream
(chip_smoke.py phase 7's 376x1241 frames, 2000 ORB2 features on 8 levels,
depth threshold 35: phase 13's configuration, whose saved map phase 21b
solves), drains local mapping and saves the map in the packages' shared
schema with its camera (``map.json`` under ``--out`` if given).  ``--map``
loads such a file instead: one of these, or the ``map.json`` of a state
that ``Slam.save_system_state`` wrote, phase 13's on the card included.
Both packages load it (``map_serialization.map_from_json``) and build the
whole-map problem with their own ``global_bundle_adjustment.
build_full_problem``, which must agree array for array.  Then, on the CPU,
with the JAX package's x64 off as it runs outside the tests: each
package's unsharded ``bundle_adjust`` in float32 and in float64,
``--iters`` LM iterations (phase 21b's 10).  With ``--device cuda`` the
JAX package is not run: the port solves twice in float32 on the card
(whose scatter adds land in atomic order) and once in float64.

Prints the final costs, the poses' largest difference, and the points'
displacement between the solves (median, 99th percentile and largest, in
metres), binned by the number of observations of a point and by its
parallax (the largest angle between two of its observing rays at the
port's float64 solution): on the CPU the port against the reference in
float32 and in float64, and each package's float32 solve against its
float64 one.  A point that the problem holds moves by the float32
rounding only; one that it leaves free (two nearly parallel rays) moves
as far as the rounding of its near-singular block lets it, in either
package.
"""

import argparse
import json
import os
import time

import numpy as np


def parallax_deg(problem, points):
    """The largest angle (degrees) between two rays observing each point,
    from the cameras of ``problem`` to ``points``."""
    poses = np.asarray(problem.poses, np.float64)
    cam = np.asarray(problem.cam_idx)
    pt = np.asarray(problem.pt_idx)
    centres = -np.einsum("cji,cj->ci", poses[:, :3, :3], poses[:, :3, 3])
    rays = points[pt] - centres[cam]
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    out = np.zeros(len(points))
    order = np.argsort(pt, kind="stable")
    bounds = np.searchsorted(pt[order], np.arange(len(points) + 1))
    for p in range(len(points)):
        r = rays[order[bounds[p]:bounds[p + 1]]]
        if len(r) >= 2:
            out[p] = np.degrees(np.arccos(np.clip((r @ r.T).min(), -1.0, 1.0)))
    return out


def bins(num_obs, parallax):
    """(label, mask) of the observation-count and parallax bins."""
    out = [(f"{lo}{'+' if hi is None else '-' + str(hi)} obs",
            (num_obs >= lo) & (True if hi is None else num_obs <= hi))
           for lo, hi in ((2, 2), (3, 4), (5, None))]
    out += [(f"parallax {lo}-{hi} deg", (parallax >= lo) & (parallax < hi))
            for lo, hi in ((0, 0.5), (0.5, 2), (2, 180))]
    out.append(("well held (>= 3 obs, >= 2 deg)", (num_obs >= 3) & (parallax >= 2)))
    return out


def displacement_table(pairs, num_obs, parallax):
    for name, a, b in pairs:
        d = np.linalg.norm(a - b, axis=1)
        print(f"{name}:", flush=True)
        for label, m in bins(num_obs, parallax):
            if m.any():
                print(f"    {label:34s} {int(m.sum()):5d} points: median {np.median(d[m]):.3g} m, "
                      f"p99 {np.percentile(d[m], 99):.3g} m, max {d[m].max():.3g} m", flush=True)


def main_stage_camera():
    import chip_smoke
    from pyslam_tpu_torch.slam.camera import PinholeCamera

    ds = chip_smoke.bench_stream("STEREO")
    return PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                         bf=ds.fx * chip_smoke.BASELINE_M, depth_threshold=35.0)


def session_map(frames, out):
    """The port's stereo session on the CPU over the main stage's first
    ``frames`` frames, drained; its map as the shared schema's dict."""
    import chip_smoke
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.map_serialization import map_to_json
    from pyslam_tpu_torch.slam.slam import Slam

    t0 = time.perf_counter()
    ds = chip_smoke.bench_stream("STEREO")
    n = min(frames, len(ds))
    cam = main_stage_camera()
    slam = Slam(cam, FeatureTrackerConfig(num_features=chip_smoke.N_FEATURES,
                                          num_levels=chip_smoke.N_LEVELS),
                sensor_type=SensorType.STEREO, device="cpu")
    for i in range(n):
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.local_mapping.finish()
    d = map_to_json(slam.map)
    d["camera"] = cam.to_json()
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "map.json"), "w") as f:
            json.dump(d, f)
    print(f"port session: {n} frames, {slam.map.num_keyframes()} keyframes, "
          f"{slam.map.num_points()} points ({time.perf_counter() - t0:.0f} s)", flush=True)
    return d


def reference_solves(d, tp, kids, pids, iters):
    """The JAX package's problem of map ``d`` (checked identical to ``tp``)
    solved in float32 and float64 on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import jax.numpy as jnp

    import chip_smoke
    from pyslam_tpu.features.tracker import FeatureTrackerConfig
    from pyslam_tpu.features.tracker import feature_tracker_factory
    from pyslam_tpu.ops import optim
    from pyslam_tpu.slam.camera import PinholeCamera
    from pyslam_tpu.slam.global_bundle_adjustment import build_full_problem
    from pyslam_tpu.slam.map_serialization import map_from_json

    cam = PinholeCamera.from_json(d["camera"])
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=chip_smoke.N_FEATURES,
                                                           num_levels=chip_smoke.N_LEVELS))
    jp, jkids, jpids = build_full_problem(map_from_json(d, tracker, cam), cam, tracker)
    assert list(jkids) == list(kids) and np.array_equal(np.asarray(jpids), np.asarray(pids))
    for f in tp._fields:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).cpu().numpy()
        assert a.shape == b.shape and np.array_equal(a, b.astype(a.dtype)), f
    out = {"reference float32": [np.asarray(x, np.float64)
                                 for x in optim.bundle_adjust(jp, iters=iters)]}
    with jax.enable_x64(True):
        jp64 = jp._replace(**{f: jnp.asarray(np.asarray(getattr(jp, f)), jnp.float64)
                              for f in FLOAT_FIELDS})
        out["reference float64"] = [np.asarray(x, np.float64)
                                    for x in optim.bundle_adjust(jp64, iters=iters)]
    return out


FLOAT_FIELDS = ("poses", "points", "uv", "ur", "sigma2", "K", "bf")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="directory to keep the map's json in")
    ap.add_argument("--map", default=None, help="a saved map.json to load instead of a session")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    import torch

    import chip_smoke
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
    from pyslam_tpu_torch.ops import optim
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.global_bundle_adjustment import build_full_problem
    from pyslam_tpu_torch.slam.map_serialization import map_from_json

    t0 = time.perf_counter()
    if args.map:
        with open(args.map) as f:
            d = json.load(f)
    else:
        d = session_map(args.frames, args.out)
    dev = torch.device(args.device)
    if "camera" not in d:
        d["camera"] = main_stage_camera().to_json()
    cam = PinholeCamera.from_json(d["camera"])
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=chip_smoke.N_FEATURES,
                                                           num_levels=chip_smoke.N_LEVELS),
                                      device=dev)
    tp, kids, pids = build_full_problem(map_from_json(d, tracker, cam), cam, tracker,
                                        device=dev)
    C, P, O = tp.poses.shape[0], tp.points.shape[0], tp.uv.shape[0]
    tp64 = tp._replace(**{f: getattr(tp, f).double() for f in FLOAT_FIELDS})

    def port(problem):
        return [x.double().cpu().numpy() for x in optim.bundle_adjust(problem, iters=args.iters)]

    if dev.type == "cpu":
        sol = reference_solves(d, tp, kids, pids, args.iters)
        print(f"problem: {C} keyframes, {P} points, {O} observations, identical in both "
              f"packages", flush=True)
        sol["port float32"] = port(tp)
        sol["port float64"] = port(tp64)
        r32, p32 = sol["reference float32"], sol["port float32"]
        r64, p64 = sol["reference float64"], sol["port float64"]
        pairs = (("port against reference, float32", p32, r32),
                 ("reference float32 against reference float64", r32, r64),
                 ("port float32 against port float64", p32, p64),
                 ("port against reference, float64", p64, r64))
    else:
        # the JAX package does not run on the card: two float32 solves there
        # (their scatter adds land in atomic order) against one in float64
        print(f"problem: {C} keyframes, {P} points, {O} observations, on {dev}", flush=True)
        sol = {"port float32": port(tp), "port float32 again": port(tp),
               "port float64": port(tp64)}
        p64 = sol["port float64"]
        pairs = (("port float32 against port float32 again", sol["port float32"],
                  sol["port float32 again"]),
                 ("port float32 against port float64", sol["port float32"], p64),
                 ("port float32 again against port float64", sol["port float32 again"], p64))
    cost0 = float(optim.ba_cost_and_chi2(tp64)[0])
    print(f"cost before {cost0:.8g}; after {args.iters} iterations: " + ", ".join(
        f"{k} {float(v[2]):.8g}" for k, v in sol.items()), flush=True)
    print("poses, largest difference: " + "; ".join(
        f"{name} {np.abs(a[0] - b[0]).max():.3g}" for name, a, b in pairs), flush=True)
    num_obs = np.bincount(tp.pt_idx.cpu().numpy(), minlength=P)
    parallax = parallax_deg(tp64._replace(poses=tp64.poses.cpu(), cam_idx=tp64.cam_idx.cpu(),
                                          pt_idx=tp64.pt_idx.cpu()), p64[1])
    displacement_table([(name, a[1], b[1]) for name, a, b in pairs], num_obs, parallax)
    print(f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
