"""Where the ORB2_HARDNET session of tests/test_torch_slice_learned.py
parts from the JAX package's: ORB2 keypoints at response near-ties.

    python -m tests.torch_orb2_ties [--frames 6] [--features 300]
    python -m tests.torch_orb2_ties --preset ORB2 --features 500 --levels 4 --frames 2

On the first frames of tests/test_slam_e2e.py's 240x320 stereo stream,
with the JAX package's HardNet weights carried across (ORB2_HARDNET, the
default preset; ``--preset ORB2 --features 500 --levels 4`` is the
extractor of tests/test_torch_depth_in_slam.py's SGBM upgrade), prints
for each frame: the left image's slots whose keypoint differs between the packages
(with the two responses of the first such slot), the keypoints each
package keeps that the other cut (left and right images), the stereo
matches of each package's own features, and how many slots the port's row
match gives otherwise when it is handed the reference's features, and how
many left slots the port's detector gives otherwise when it is handed the
reference's image pyramid (0: the pyramid's column pass is the whole
difference).  Runs
on the CPU, the JAX package with x64 off (~1 min).
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--features", type=int, default=300)
    ap.add_argument("--preset", default="ORB2_HARDNET", choices=("ORB2_HARDNET", "ORB2"))
    ap.add_argument("--levels", type=int, default=None,
                    help="pyramid levels (default: the preset's)")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    import torch

    from pyslam_tpu.config_parameters import Parameters as P
    from pyslam_tpu.features.tracker import FeatureTrackerConfigs as JaxConfigs
    from pyslam_tpu.features.tracker import feature_tracker_factory as jax_factory
    from pyslam_tpu.io.dataset import SyntheticDataset
    from pyslam_tpu.io.dataset_types import SensorType
    from pyslam_tpu.ops import image as jax_image
    from pyslam_tpu.ops import matching as jax_matching
    from pyslam_tpu_torch.features.orb2 import FeatureData, extract_pyramid, stereo_match
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfigs, feature_tracker_factory
    from tests.test_torch_slice_learned import _carry_weights
    from tests.torch_parity import compiled_flax_init

    ds = SyntheticDataset(num_frames=args.frames, sensor_type=SensorType.STEREO,
                          trajectory="line", step=0.4)
    bf = ds.fx * ds.baseline
    max_disp = bf / max(P.kMinDepth, 1e-3)
    gate, row_tol = P.kStereoMatchingMaxDescriptorDistance, P.kStereoMatchingRowTolerance
    size = dict(num_features=args.features)
    if args.levels is not None:
        size["num_levels"] = args.levels
    with jax.enable_x64(False), compiled_flax_init():
        jt = jax_factory(dataclasses.replace(JaxConfigs.get(args.preset), **size))
    tt = feature_tracker_factory(dataclasses.replace(FeatureTrackerConfigs.get(args.preset),
                                                     **size), device="cpu")
    orb = tt.extractor
    if args.preset == "ORB2_HARDNET":
        _carry_weights(args.preset, jt, tt)
        orb = orb.base

    def keyset(xy, lv, valid):
        return {(float(x), float(y), int(v)) for (x, y), v, ok in zip(xy, lv, valid) if ok}

    for i in range(args.frames):
        left, right = ds.getImage(i), ds.getImageRight(i)
        with jax.enable_x64(False):
            jl, jr = jt.detectAndCompute(left), jt.detectAndCompute(right)
            xyl, xyr = np.asarray(jl.xy), np.asarray(jr.xy)
            d = jt.matcher.distance_matrix(jl.desc, jr.desc)
            idx, _ = jax_matching.row_stereo_match(
                d, jnp.asarray(xyl[:, 1]), jnp.asarray(xyr[:, 1]),
                jnp.asarray(xyl[:, 0:1] - xyr[None, :, 0]), max_distance=gate,
                row_tol=row_tol, min_disp=0.1, max_disp=max_disp, valid_a=jl.valid,
                valid_b=jr.valid)
            jpyr = jax_image.build_pyramid(jnp.asarray(left, jnp.float32), orb.num_levels,
                                           orb.scale_factor)
        n_ref = int((np.asarray(idx) >= 0).sum())
        fed = extract_pyramid([torch.from_numpy(np.array(p))[None] for p in jpyr],
                              orb.num_features, orb.scale_factor, orb.fast_threshold, orb.cell,
                              orb.per_cell)
        fed_diff = int(((np.abs(fed.xy[0].numpy() - xyl).max(1) > 0)
                        | (fed.valid[0].numpy() != np.asarray(jl.valid))).sum())
        gl, ur, _ = tt.extractor.extract_stereo(left, right, bf=bf, max_disp=max_disp,
                                                max_distance=gate, row_tol=row_tol)
        gr = tt.detectAndCompute(right)
        diff = np.nonzero(np.abs(xyl - gl.xy.numpy()).max(1) > 0)[0]
        resp = (f" (slot {diff[0]}: responses {float(np.asarray(jl.response)[diff[0]]):.8g} "
                f"and {float(gl.response[diff[0]]):.8g})" if len(diff) else "")
        cut = []
        for name, jf, gf in (("left", jl, gl), ("right", jr, gr)):
            a = keyset(np.asarray(jf.xy), np.asarray(jf.level), np.asarray(jf.valid))
            b = keyset(gf.xy.numpy(), gf.level.numpy(), gf.valid.numpy())
            cut.append(f"{name}: {sorted(b - a)} in the port only, {sorted(a - b)} in the "
                       f"reference only")
        ref_t = [FeatureData(*[torch.from_numpy(np.array(x)) for x in f]) for f in (jl, jr)]
        ur_ref, _ = stereo_match(*ref_t, bf, max_disp, gate, row_tol)
        u_ref = np.where(np.asarray(idx) >= 0, xyr[np.clip(np.asarray(idx), 0, None), 0], -1.0)
        same_match = int((np.abs(ur_ref.numpy() - u_ref) == 0).sum())
        print(f"frame {i}: {len(diff)} left slots differ{resp}; {'; '.join(cut)}; stereo "
              f"matches: reference {n_ref}, port {int((ur >= 0).sum())}; the port's row "
              f"match on the reference's features agrees on {same_match}/{len(u_ref)} slots; "
              f"given the reference's pyramid, {fed_diff} left slots differ",
              flush=True)


if __name__ == "__main__":
    main()
