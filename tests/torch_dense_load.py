"""How full the voxel table of the bench configuration gets, and what the
insert drops then, with ground-truth poses.

    python -m tests.torch_dense_load [--every 3] [--device cpu] [--reference]

Runs the integrator that chip_smoke.py attaches (bench.py's main stage:
TSDF, voxel 0.2 m, sdf_trunc 0.6 m, depth truncation 40 m, SGM depth at
downscale 2, a 1 << 22-slot table, 3 phases a keyframe) over the 60 frames
of chip_smoke.py's 376x1241 stream, a keyframe every ``--every`` frames at
its ground-truth pose.  For each keyframe it prints the distinct voxels
its updates touch, the table's load factor after the keyframe beside
chip_smoke.py's ceiling for that many keyframes (``load_ceiling``), the
probe-sequence faults (``voxel_hash.probe_faults``) and the share of that
keyframe's valid updates still unresolved after the insert's claim rounds
(dropped).

``--reference`` runs the JAX package's integrator (built by its factory with
the same flags, on the CPU, x64 off as the package runs) on the same images
and poses beside the port's, and prints for each keyframe its load factor,
the valid updates it dropped (those whose key the table does not hold after
the insert) and whether its table (keys, occupancy, tsdf, weight, colour)
equals the port's bit for bit.
"""

import argparse

import numpy as np
import torch

import chip_smoke
from pyslam_tpu_torch.ops import voxel_hash
from pyslam_tpu_torch.slam.camera import PinholeCamera


def reference_integrator(ds):
    """The JAX package's integrator with the flags of chip_smoke.build_integrator."""
    from pyslam_tpu.config_parameters import Parameters
    from pyslam_tpu.dense.volumetric_integrator import (VolumetricIntegratorType,
                                                        volumetric_integrator_factory)
    from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera

    Parameters.kVolumetricIntegrationUseDepthEstimator = True
    Parameters.kVolumetricIntegrationDepthEstimatorType = "sgbm"
    Parameters.kVolumetricIntegrationDepthTruncOutdoor = chip_smoke.DEPTH_TRUNC_OUTDOOR
    cam = JaxCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                    bf=ds.fx * ds.baseline, depth_threshold=35.0)
    integ = volumetric_integrator_factory(
        VolumetricIntegratorType.TSDF, camera=cam,
        environment_type=type("E", (), {"name": "OUTDOOR"})(),
        voxel_size=chip_smoke.VOXEL_SIZE, sdf_trunc=chip_smoke.SDF_TRUNC)
    return integ, cam


def reference_keyframe(vol, est, cam, left, right, Twc):
    """(dropped, valid) of one keyframe fused into the JAX package's volume
    phase by phase; dropped: valid updates whose key the table does not
    hold after the phase's insert."""
    import jax.numpy as jnp

    from pyslam_tpu.dense.tsdf import depth_to_voxel_updates
    from pyslam_tpu.ops import voxel_hash

    depth = est.infer_depth_device(left, right)
    args = [jnp.asarray(a, jnp.float32) for a in (left, Twc, cam.K)]
    dropped = valid = 0
    for phase in range(chip_smoke.TSDF_PHASES):
        coords, _, _, _, ok = depth_to_voxel_updates(
            depth, args[0], args[1], args[2], vol.voxel_size, vol.sdf_trunc, vol.depth_trunc,
            stride=vol.stride, band_steps=vol.band_steps, phase=phase,
            phases=chip_smoke.TSDF_PHASES)
        vol.integrate(depth, left, Twc, cam.K, phase=phase, phases=chip_smoke.TSDF_PHASES)
        ok = np.asarray(ok)
        dropped += int((ok & (np.asarray(voxel_hash.lookup(vol.table, coords)) < 0)).sum())
        valid += int(ok.sum())
    return dropped, valid


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--every", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    ds = chip_smoke.bench_stream()
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=35.0)
    integ = chip_smoke.build_integrator(cam, dev)
    vol = integ.volume
    # an empty depth map inserts nothing and makes the volume pick its stride
    empty = np.zeros((ds.h, ds.w), np.float32)
    vol.integrate(empty, ds.getImage(0), np.eye(4), cam.K)
    if args.reference:
        import jax

        jax.config.update("jax_enable_x64", False)
        ref, ref_cam = reference_integrator(ds)
        ref.volume.integrate(empty, ds.getImage(0), np.eye(4), ref_cam.K)
    frames = [(ds.getImage(f), ds.getImageRight(f), 0) for f in range(chip_smoke.N_FRAMES)]
    per_frame = chip_smoke.frame_voxels(vol, integ._depth_provider, cam, frames,
                                        ds.poses[:chip_smoke.N_FRAMES])
    for n, f in enumerate(range(0, chip_smoke.N_FRAMES, args.every), 1):
        left, right, Twc = ds.getImage(f), ds.getImageRight(f), ds.poses[f]
        dropped, valid = chip_smoke.keyframe_drops(vol, integ._depth_provider, cam, left, right,
                                                   Twc, insert=True)
        faults = voxel_hash.probe_faults(vol.table)
        print(f"frame {f}: {per_frame[f]} distinct voxels, {vol.num_voxels()} in the table, "
              f"load factor {vol.num_voxels() / vol.capacity:.4f} (ceiling "
              f"{chip_smoke.load_ceiling(per_frame, n, vol.capacity):.4f} for {n} keyframes), "
              f"faults {faults}, dropped {dropped} of {valid} valid updates "
              f"({dropped / max(valid, 1) * 100:.3f}%)", flush=True)
        if args.reference:
            r_drop, r_valid = reference_keyframe(ref.volume, ref._depth_provider, ref_cam, left,
                                                 right, Twc)
            same = all(np.array_equal(np.asarray(getattr(ref.volume.table, k)),
                                      getattr(vol.table, k).cpu().numpy())
                       for k in ("keys", "occupied", "tsdf", "weight", "color"))
            print(f"  reference: {ref.volume.num_voxels()} voxels, load factor "
                  f"{ref.volume.num_voxels() / ref.volume.capacity:.4f}, dropped {r_drop} of "
                  f"{r_valid} valid updates ({r_drop / max(r_valid, 1) * 100:.3f}%); table "
                  f"{'identical to' if same else 'DIFFERENT from'} the port's",
                  flush=True)


if __name__ == "__main__":
    main()
