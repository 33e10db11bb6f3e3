"""How often the PnP RANSAC's linear 6-point DLT finds the pose on a scene
like phase 13b's relocalisation (the camera on the line 20 m in, points 4-70
m in front of it, 0.3 px of noise), with its 12x12 eigen-solve in float32
(``dlt_float32``, the earlier solve) or in float64 (``pnp._dlt_pnp``), on
a device.

    PYTHONPATH=. python3 tests/torch_pnp_conditioning.py [--device cuda] [--trials 20]

For each trial it prints nothing; at the end, per solve precision, the
inliers of the best hypothesis (of 85 correspondences, 500 hypotheses) and
the share of the 500 hypotheses that keep at least 30 inliers.
"""

import argparse

import numpy as np
import torch

from pyslam_tpu_torch.ops import lie, pnp
from pyslam_tpu_torch.ops.epipolar import generator_sampler

FX = 718.856


def dlt_float32(pts3d, xy):
    """``pnp._dlt_pnp`` with its eigen-solve in float32 (the port's earlier
    solve, and the JAX package's with x64 off)."""
    X = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], -1)
    zeros = torch.zeros_like(X)
    x, y = xy[..., 0:1], xy[..., 1:2]
    A = torch.cat([torch.cat([X, zeros, -x * X], -1), torch.cat([zeros, X, -y * X], -1)], -2)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 4)
    P = P * torch.where(lie.det3(P[..., :3]) < 0, -1.0, 1.0)[..., None, None]
    scale = lie._cbrt(torch.clamp(lie.det3(P[..., :3]), min=1e-12))
    R = lie.project_to_SO3(P[..., :3] / scale[..., None, None])
    return lie.rt_to_T(R, P[..., 3] / scale[..., None])


def scene(rng, n=85, zc=20.0, noise_px=0.3):
    pts = np.stack([rng.uniform(-25, 25, n), rng.uniform(-6, 6, n), zc + rng.uniform(4, 70, n)],
                   1)
    Tcw = np.eye(4)
    Tcw[2, 3] = -zc
    pc = pts + Tcw[:3, 3]
    xy = pc[:, :2] / pc[:, 2:3] + rng.normal(0, noise_px / FX, (n, 2))
    return pts.astype(np.float32), xy.astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trials", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    th2 = 5.99 / FX ** 2
    out = {"float32": [], "float64": []}
    good = {"float32": [], "float64": []}
    for trial in range(args.trials):
        pts, xy = scene(rng)
        p, x = torch.from_numpy(pts).to(dev), torch.from_numpy(xy).to(dev)
        valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
        samples = generator_sampler(dev, trial)(valid, 500, 6, None)
        for prec, dlt in (("float32", dlt_float32), ("float64", pnp._dlt_pnp)):
            Ts = dlt(p[samples], x[samples])
            inl = (pnp._reproj_err2(Ts, p, x) < th2).sum(1)
            out[prec].append(int(inl.max()))
            good[prec].append(float((inl >= 30).float().mean()))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for prec in out:
        print(f"{name} {prec} DLT: best-hypothesis inliers of 85 {out[prec]}; hypotheses "
              f"with >= 30 inliers {np.round(good[prec], 3).tolist()}", flush=True)


if __name__ == "__main__":
    main()
