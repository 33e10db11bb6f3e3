"""The port's device mesh and observation-sharded bundle adjustment
(``pyslam_tpu_torch/parallel``) against its one-device ``bundle_adjust``
and against the JAX package's ``bundle_adjust_sharded`` on its 8-device CPU
mesh, with the reference's problems (``tests.test_optim.make_problem``) and
tolerances (``tests/test_parallel.py``: poses within 1e-5, points within
1e-4).  The port's 8 shards share the CPU through an explicit device list."""

import jax
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from pyslam_tpu.parallel.sharded_ba import bundle_adjust_sharded as jsharded
from pyslam_tpu.parallel.sharded_ba import pad_problem_for_mesh as jpad
from pyslam_tpu_torch.ops import optim as toptim
from pyslam_tpu_torch.parallel.mesh import Mesh, make_mesh, obs_sharding, replicated
from pyslam_tpu_torch.parallel.sharded_ba import (bundle_adjust_sharded, pad_problem_for_mesh,
                                                  shard_problem)
from tests.test_optim import make_problem

CPU8 = Mesh([torch.device("cpu")] * 8)


def _port_problem(jp):
    """The JAX problem's arrays as the port's BAProblem (same dtypes)."""
    return toptim.BAProblem(*[torch.as_tensor(np.array(x)) for x in jp])


def test_sharded_matches_one_device_and_the_reference():
    rng = np.random.default_rng(0)
    jp, _, _ = make_problem(rng)
    tp = _port_problem(jp)
    assert tp.uv.shape[0] % 8, "the case must exercise the padding"
    p1, x1, c1 = toptim.bundle_adjust(tp, iters=8)
    traffic = {}
    p8, x8, c8 = bundle_adjust_sharded(tp, iters=8, mesh=CPU8, traffic=traffic)
    np.testing.assert_allclose(p8.numpy(), p1.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(x8.numpy(), x1.numpy(), rtol=0, atol=1e-4)
    pj, xj, _ = jsharded(jp, iters=8, mesh=jmake_mesh(8))
    np.testing.assert_allclose(p8.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(x8.numpy(), np.asarray(xj), rtol=0, atol=1e-4)
    # per LM step: 5 reductions, A and B, tp and the new cost from 7 shards
    P, C = tp.points.shape[0], tp.poses.shape[0]
    per_shard = (C * 36 + P * 9 + C * 6 + P * 3 + 1 + 2 * P * C * 18 + P * 3 + 1) * 8
    assert traffic["reduce"] == 7 * (per_shard * 8 + 8)   # + the initial cost
    assert traffic["broadcast"] > 0


def test_sharded_converges():
    """The reference's converge case (tests/test_parallel.py)."""
    rng = np.random.default_rng(0)
    jp, _, _ = make_problem(rng, stereo=True)
    tp = _port_problem(jp)
    cost0, _, _ = toptim.ba_cost_and_chi2(tp, use_robust=False)
    poses, points, _ = bundle_adjust_sharded(tp, iters=15, mesh=CPU8)
    costf, _, _ = toptim.ba_cost_and_chi2(tp._replace(poses=poses, points=points),
                                          use_robust=False)
    assert float(costf) < 0.2 * float(cost0)


def test_padding_and_shards_match_the_reference():
    rng = np.random.default_rng(1)
    jp, _, _ = make_problem(rng)
    tp = _port_problem(jp)
    want = jpad(jp, 8)
    got = pad_problem_for_mesh(tp, 8)
    for f in ("cam_idx", "pt_idx", "uv", "ur", "sigma2", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    shards = shard_problem(got, CPU8)
    assert len(shards) == 8
    np.testing.assert_array_equal(torch.cat([s.uv for s in shards]).numpy(), got.uv.numpy())
    assert all(torch.equal(s.poses, tp.poses) for s in shards)
    x = torch.arange(12.0).reshape(6, 2)
    assert [c.tolist() for c in obs_sharding(x, Mesh(["cpu"] * 3))] == \
        [[[0.0, 1.0], [2.0, 3.0]], [[4.0, 5.0], [6.0, 7.0]], [[8.0, 9.0], [10.0, 11.0]]]
    assert all(torch.equal(c, x) for c in replicated(x, Mesh(["cpu"] * 2)))
    with pytest.raises(ValueError):
        obs_sharding(torch.zeros(5), Mesh(["cpu"] * 2))


def test_make_mesh_counts_real_devices():
    """The default mesh is every CUDA device; asking for more devices than
    there are raises (no fallback to the CPU)."""
    n = torch.cuda.device_count()
    if n < 2:
        with pytest.raises(ValueError):
            make_mesh(2)
    else:
        assert make_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    if n == 0:
        with pytest.raises(ValueError):
            make_mesh()
    mesh = make_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),) and mesh.axis == "obs"
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")
    assert jax.device_count() >= 8   # the reference's mesh, for the comparison above


def test_gba_sharded_matches_unsharded():
    """``global_bundle_adjustment(use_sharded=True)`` on a small map writes
    what the one-device solve writes.  The GBA's problem is float32, where
    the sums' order alone moves a point 20 m away by ~1.5e-5 of its
    distance: poses within 1e-5, points within 1e-4 of max(|x|, 1 m)."""
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.global_bundle_adjustment import global_bundle_adjustment
    from pyslam_tpu_torch.slam.slam import Slam

    ds = SyntheticDataset(num_frames=8, sensor_type=SensorType.STEREO, trajectory="line",
                          step=0.45)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=300, num_levels=3),
                sensor_type=SensorType.STEREO, device="cpu")
    for i in range(len(ds)):
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.local_mapping.finish()
    m = slam.map
    assert m.num_keyframes() >= 3
    kids, pids = list(m.keyframe_order), m.points.alive_ids()
    poses0 = {k: m.keyframes[k].Tcw.copy() for k in kids}
    pos0 = m.points.pos.copy()
    out = {}
    for sharded in (False, True):
        for k in kids:
            m.keyframes[k].update_pose(poses0[k])
        m.points.pos[:] = pos0
        cost = global_bundle_adjustment(m, cam, slam.feature_tracker, iters=6,
                                        use_sharded=sharded, mesh=Mesh(["cpu"] * 4),
                                        device="cpu")
        assert np.isfinite(cost)
        out[sharded] = (np.stack([m.keyframes[k].Tcw for k in kids]), m.points.pos[pids].copy())
    assert np.abs(out[True][0] - np.stack([poses0[k] for k in kids])).max() > 0   # it moved
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=0, atol=1e-5)
    scale = np.maximum(np.abs(out[False][1]), 1.0)
    assert np.max(np.abs(out[True][1] - out[False][1]) / scale) < 1e-4
