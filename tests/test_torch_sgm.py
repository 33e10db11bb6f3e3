"""The port's semi-global matcher and SGBM depth estimator against
``pyslam_tpu.depth_estimation`` on the same synthetic stereo pair, the
reference with x64 off as the JAX package runs.

Everything before the sub-pixel step holds small integers in float32, so
the census bits, the cost volume, the aggregated volume and the disparity
map (integer part, masks, and the sub-pixel value, a division of two such
integers) are identical: tolerance 0, measured at 60x80, 120x160 and
240x320.  The downscale-2 depth (2x2 mean, nearest upsample, ``bf / d``)
is identical too, on integer and on fractional grey levels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)
from pyslam_tpu.depth_estimation import depth_estimator as JD
from pyslam_tpu.depth_estimation import sgm as J
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu_torch.depth_estimation import depth_estimator as TD
from pyslam_tpu_torch.depth_estimation import sgm as T
from pyslam_tpu_torch.slam.camera import PinholeCamera
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)


@pytest.fixture(scope="module")
def pair():
    ds = JaxSyntheticDataset(num_frames=1, sensor_type=JaxSensorType.STEREO)
    return ds, ds.getImage(0).astype(np.float32), ds.getImageRight(0).astype(np.float32)


SIZES = [(60, 80), (120, 160)]


@pytest.mark.parametrize("hw", SIZES)
def test_census_and_cost_volume_identical(pair, hw):
    _, L, R = pair
    l, r = L[:hw[0], :hw[1]].copy(), R[:hw[0], :hw[1]].copy()
    with jax.enable_x64(False):
        cl, cr = J.census_transform(jnp.asarray(l)), J.census_transform(jnp.asarray(r))
        vol = np.asarray(J.cost_volume(cl, cr, 32))
    tl, tr = T.census_transform(torch.from_numpy(l)), T.census_transform(torch.from_numpy(r))
    assert np.array_equal(tl.numpy(), np.asarray(cl)) and np.array_equal(tr.numpy(), np.asarray(cr))
    got = T.cost_volume(tl, tr, 32)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), vol)


@pytest.mark.parametrize("hw", SIZES)
def test_aggregate_4dir_identical(pair, hw):
    _, L, R = pair
    rng = np.random.default_rng(hw[0])
    vol = rng.integers(0, 25, (*hw, 32)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(J._aggregate_4dir(jnp.asarray(vol), 8.0, 64.0, 32, 16))
    got = T._aggregate_4dir(torch.from_numpy(vol), 8.0, 64.0, 32, 16).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("hw", SIZES)
def test_sgm_disparity_identical(pair, hw):
    _, L, R = pair
    l, r = L[:hw[0], :hw[1]].copy(), R[:hw[0], :hw[1]].copy()
    with jax.enable_x64(False):
        ref = np.asarray(J.sgm_disparity(jnp.asarray(l), jnp.asarray(r), max_disp=32))
    got = T.sgm_disparity(torch.from_numpy(l), torch.from_numpy(r), max_disp=32).numpy()
    assert np.array_equal(got == J.INVALID, ref == J.INVALID)
    assert np.array_equal(got, ref)
    assert (ref > 0).mean() > 0.5


def test_sgm_ties_keep_the_first_disparity():
    """A flat image makes every cost tie: the first disparity (0) wins, so
    the map is invalid everywhere in both packages."""
    flat = np.full((40, 64), 100.0, np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(J.sgm_disparity(jnp.asarray(flat), jnp.asarray(flat), max_disp=16))
    got = T.sgm_disparity(torch.from_numpy(flat), torch.from_numpy(flat), max_disp=16).numpy()
    assert np.array_equal(got, ref) and (got == J.INVALID).all()


def _cams(ds):
    kw = (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    return JaxCamera(*kw, bf=ds.fx * ds.baseline), PinholeCamera(*kw, bf=ds.fx * ds.baseline)


@pytest.mark.parametrize("crop", [(240, 320), (239, 319)])
def test_downscale2_depth_identical(pair, crop):
    """The integrator's estimator (downscale 2, 32 disparities) on a full
    frame and on one with odd sides (a row and a column of -1 padding)."""
    ds, L, R = pair
    l, r = L[:crop[0], :crop[1]].copy(), R[:crop[0], :crop[1]].copy()
    cj, ct = _cams(ds)
    ej = JD.DepthEstimatorSgbm(cj, downscale=2)
    et = TD.DepthEstimatorSgbm(ct, downscale=2, device="cpu")
    with jax.enable_x64(False):
        disp_ref = np.asarray(ej._disparity_full_scale(l, r))
        depth_dev_ref = np.asarray(ej.infer_depth_device(l, r))
        depth_ref, pts_ref = ej.infer(l, r)
    assert np.array_equal(et._disparity_full_scale(l, r).numpy(), disp_ref)
    dev_depth = et.infer_depth_device(l, r)
    assert dev_depth.device.type == "cpu" and dev_depth.dtype == torch.float32
    assert np.array_equal(dev_depth.numpy(), depth_dev_ref)
    depth, pts = et.infer(l, r)
    assert np.array_equal(depth, depth_ref) and np.array_equal(pts, pts_ref)
    assert (depth > 0).mean() > 0.3


def test_downscale2_mean_of_fractional_images(pair):
    """On images with fractional grey levels (as the 376x1241 stream renders)
    the 2x2 mean rounds, so its sum must run in the reference's order."""
    ds, L, R = pair
    rng = np.random.default_rng(7)
    l = (L + rng.uniform(0, 1, L.shape)).astype(np.float32)
    r = (R + rng.uniform(0, 1, R.shape)).astype(np.float32)
    cj, ct = _cams(ds)
    with jax.enable_x64(False):
        disp_ref = np.asarray(JD.DepthEstimatorSgbm(cj, downscale=2)._disparity_full_scale(l, r))
    disp = TD.DepthEstimatorSgbm(ct, downscale=2, device="cpu")._disparity_full_scale(l, r)
    assert np.array_equal(disp.numpy(), disp_ref)


def test_depth_against_ground_truth():
    """The reference's own check (tests/test_depth.py): median relative
    error under 15 % on close structure."""
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=1, sensor_type=SensorType.STEREO)
    gt = np.asarray(SyntheticDataset(num_frames=1, sensor_type=SensorType.RGBD).getDepth(0))
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, bf=ds.fx * ds.baseline)
    est = TD.depth_estimator_factory(TD.DepthEstimatorType.DEPTH_SGBM, camera=cam,
                                     max_depth=45.0, device="cpu")
    depth, pts3d = est.infer(ds.getImage(0), ds.getImageRight(0))
    ok = (depth > 0) & (gt > 0) & (gt < 20.0)
    assert ok.mean() > 0.05
    assert np.median(np.abs(depth[ok] - gt[ok]) / gt[ok]) < 0.15
    assert pts3d.shape == depth.shape + (3,)


def test_factory_routes_as_the_reference():
    cam = PinholeCamera(64, 48, 50, 50, 32, 24, bf=5.0)
    for name in ("sgbm", "raft_stereo", "crestereo", "crestereo_megengine"):
        est = TD.depth_estimator_factory(name, camera=cam, device="cpu", downscale=2)
        assert isinstance(est, TD.DepthEstimatorSgbm) and est.downscale == 2
    # the learned estimators and the stereo networks given a checkpoint are
    # built (their models: tests/test_torch_depth_estimators.py); a missing
    # checkpoint file is the loader's error, not a refusal
    for name, cls in (("depth_anything_v2", "DepthEstimatorDepthAnything"),
                      ("depth_anything_v3", "DepthEstimatorDepthAnythingV3"),
                      ("mvdust3r", "DepthEstimatorMVDust3r")):
        est = TD.depth_estimator_factory(name, camera=cam, device="cpu")
        assert type(est).__name__ == cls and est.model.net.training is False
    for name in ("raft_stereo", "crestereo"):
        with pytest.raises(FileNotFoundError):
            TD.depth_estimator_factory(name, camera=cam, device="cpu", checkpoint="x.npz")
