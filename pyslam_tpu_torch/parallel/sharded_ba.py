"""Observation-sharded bundle adjustment over a device mesh (port of
``pyslam_tpu/parallel/sharded_ba.py``).

The normal equations of the GBA are sums over observations.  The
observations (cam_idx, pt_idx, uv, ur, sigma2, valid) are split over the
mesh; poses, points and the rest are copied to every device.  In the
reference GSPMD turns the segment sums into per-shard partial sums and a
``psum``; here ``ops.optim._lm_step`` does so itself: each shard assembles
Hcc, Hpp, bc, bp and the cost, they are reduced onto the first mesh device
in shard order, Hpp^-1 goes back to the shards, their per-(point, camera)
Schur blocks A and B (P*C, 18) are reduced, the reduced camera system is
solved on the first device, and dc goes out for the point updates.
``ops.optim.bundle_adjust`` is the one-shard case.
"""

from __future__ import annotations

import torch

from pyslam_tpu_torch.ops import optim
from pyslam_tpu_torch.parallel.mesh import Mesh, make_mesh, obs_sharding, replicated

OBS_FIELDS = ("cam_idx", "pt_idx", "uv", "ur", "sigma2", "valid")


def pad_problem_for_mesh(problem: optim.BAProblem, n_devices: int) -> optim.BAProblem:
    """Pad the observation rows to a multiple of the mesh size with rows
    that weigh nothing (camera 0, point 0, ur -1, sigma2 1, valid False)."""
    O = problem.uv.shape[0]
    pad = -(-O // n_devices) * n_devices - O
    if pad == 0:
        return problem

    def padded(x, fill):
        return torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                                        device=x.device)])

    fills = {"cam_idx": 0, "pt_idx": 0, "uv": 0.0, "ur": -1.0, "sigma2": 1.0, "valid": False}
    return problem._replace(**{f: padded(getattr(problem, f), fills[f]) for f in OBS_FIELDS})


def shard_problem(problem: optim.BAProblem, mesh: Mesh) -> list[optim.BAProblem]:
    """One BAProblem a mesh device: its block of the observation rows
    (their count must split evenly: ``pad_problem_for_mesh``), everything
    else copied."""
    fields = {f: (obs_sharding if f in OBS_FIELDS else replicated)(getattr(problem, f), mesh)
              for f in optim.BAProblem._fields}
    return [optim.BAProblem(**{f: fields[f][i] for f in optim.BAProblem._fields})
            for i in range(mesh.size)]


def bundle_adjust_sharded(problem: optim.BAProblem, iters: int = 10, mesh: Mesh | None = None,
                          use_robust: bool = True, traffic: dict | None = None, *,
                          device: torch.device | str = "cuda"):
    """The Schur-LM bundle adjuster with the observations sharded over
    ``mesh`` (by default every visible device of ``device``'s type).
    Returns (poses, points, final cost) on the mesh's first device; with a
    ``traffic`` dict, adds to its "reduce" and "broadcast" entries the bytes
    the shards exchange."""
    if mesh is None:
        mesh = make_mesh(device=device)
    if traffic is not None:
        traffic.setdefault("reduce", 0)
        traffic.setdefault("broadcast", 0)
    shards = shard_problem(pad_problem_for_mesh(problem, mesh.size), mesh)
    poses, points, cost, _ = optim.bundle_adjust_shards(shards, iters, use_robust,
                                                        traffic=traffic)
    return poses, points, cost
