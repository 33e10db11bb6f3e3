"""Whether a keyframe's view drifts once it leaves the Gaussian-splatting
window, in the JAX package as in the port: both volumes at their defaults
(capacity 60000, tile_k 48, 30 steps, window 3, seed stride 4) are driven
directly with the same keyframes, each view's PSNR is taken right after its
own integration and again at the end of the session.

The keyframes: ``KEYFRAMES`` (11 frames spread evenly over the first 20)
of the stream of ``chip_smoke.py``'s phase 9 at their ground-truth poses,
with its world, trajectory and field of view, rendered at a quarter of its
size (94x310, a 80x304 raster: the full size is for the card), depth
truncated at 100 m as in phase 19d.  The JAX package runs with x64 off.

    python tests/torch_gs_drift.py [--package both|jax|port] [--perturb SEED]
                                   [--device cpu|cuda]

prints one JSON line per package: the PSNR after each keyframe's
integration, at the session's end, and their means.  ``--perturb`` moves
each valid depth by one float32 rounding step (a random sign a pixel, from the
seed), which shows how far a run's PSNRs spread from roundings alone;
``--device`` is the port's (the JAX package runs on the CPU).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KEYFRAMES = [int(i) for i in np.linspace(0, 19, 11).round()]
SCALE = 4
DEPTH_TRUNC = 100.0
# chip_smoke.py's phase 9 stream: its world's extent follows its 60 frames
N_STREAM, H, W, FX, BASELINE_M = 60, 376, 1241, 718.856, 0.54


def psnr(a, b) -> float:
    return float(-10.0 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-12)))


def keyframes(perturb=None):
    """(image, depth, Twc, K) of each keyframe, from the port's stream (the
    same numpy renderer as the JAX package's)."""
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset, SyntheticWorld

    extent = max(60.0, (N_STREAM * 0.8 + 30.0) / 1.4)
    world = SyntheticWorld(n_points=16000, extent=extent, depth_range=(4.0, 80.0))
    ds = SyntheticDataset(num_frames=N_STREAM, h=H // SCALE, w=W // SCALE, fx=FX / SCALE,
                          baseline=BASELINE_M, trajectory="line", step=0.8,
                          sensor_type=SensorType.RGBD, world=world)
    K = np.array([[ds.fx, 0, ds.cx], [0, ds.fy, ds.cy], [0, 0, 1]], np.float64)
    kfs = [(ds.getImage(i), np.asarray(ds.getDepth(i), np.float32), ds.poses[i], K)
           for i in KEYFRAMES]
    if perturb is not None:
        r = np.random.default_rng(perturb)
        kfs = [(img, np.where(d > 0, np.nextafter(d, np.where(
            r.uniform(size=d.shape) < 0.5, 0.0, np.inf).astype(np.float32)), d), T, K)
            for img, d, T, K in kfs]
    return kfs


def drive(vol, integrate, kfs) -> dict:
    t0 = time.perf_counter()
    fitted = []
    for img, depth, Twc, K in kfs:
        integrate(vol, depth, img, Twc, K)
        rh, rw = vol.render_hw
        color = np.asarray(vol.render(np.linalg.inv(Twc), K)[0])[..., 0]
        fitted.append(psnr(color, np.asarray(img, np.float32)[:rh, :rw] / 255.0))
    end = []
    for img, _, Twc, K in kfs:
        color = np.asarray(vol.render(np.linalg.inv(Twc), K)[0])[..., 0]
        end.append(psnr(color, np.asarray(img, np.float32)[:rh, :rw] / 255.0))
    return dict(keyframes=KEYFRAMES, raster=[rh, rw], gaussians=int(vol.num_used),
                fitted_psnr_db=fitted, end_psnr_db=end, mean_fitted_db=float(np.mean(fitted)),
                mean_end_db=float(np.mean(end)), seconds=time.perf_counter() - t0)


def run_jax(kfs) -> dict:
    import jax

    from pyslam_tpu.dense.gaussian_splatting_integrator import GaussianSplattingVolume

    with jax.enable_x64(False):
        return drive(GaussianSplattingVolume(depth_trunc=DEPTH_TRUNC),
                     lambda v, d, i, T, K: v.integrate(d, i, T, K), kfs)


def run_port(kfs, device="cpu") -> dict:
    from pyslam_tpu_torch.dense.gaussian_splatting_integrator import GaussianSplattingVolume

    return drive(GaussianSplattingVolume(depth_trunc=DEPTH_TRUNC, device=device),
                 lambda v, d, i, T, K: v.integrate(d, i, T, K), kfs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("both", "jax", "port"), default="both")
    ap.add_argument("--perturb", type=int, default=None)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    kfs = keyframes(args.perturb)
    if args.package in ("both", "jax"):
        print(json.dumps({"jax": run_jax(kfs)}), flush=True)
    if args.package in ("both", "port"):
        print(json.dumps({"port": run_port(kfs, args.device)}), flush=True)


if __name__ == "__main__":
    main()
