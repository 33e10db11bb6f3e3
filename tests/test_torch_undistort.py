"""Lens undistortion of the port against the JAX package: ``undistort_pixels``
(10 fixed-point iterations), ``distort_radtan``, their round trip, and the
undistorted image bounds of ``PinholeCamera`` with TUM-like and
EuRoC-like radial-tangential coefficients.  Tolerance 1e-5 px; measured
identical (the port rounds the iteration as the reference's compiled loop
does, with its fused multiply-adds)."""

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import rng

from pyslam_tpu.ops import geometry as jgeom
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu_torch.ops import geometry
from pyslam_tpu_torch.slam.camera import PinholeCamera
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL_PX = 1e-5
# (width, height, fx, fy, cx, cy), D: TUM fr1, fr2, fr3 and EuRoC cam0
CAMERAS = {
    "tum_fr1": ((640, 480, 517.306408, 516.469215, 318.643040, 255.313989),
                [0.262383, -0.953104, -0.005358, 0.002628, 1.163314]),
    "tum_fr2": ((640, 480, 520.908620, 521.007327, 325.141442, 249.701764),
                [0.231222, -0.784899, -0.003257, -0.000105, 0.917205]),
    "tum_fr3": ((640, 480, 535.4, 539.2, 320.1, 247.6), [0.0, 0.0, 0.0, 0.0, 0.0]),
    "euroc": ((752, 480, 458.654, 457.296, 367.215, 248.375),
              [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]),
}


def _pixels(w, h, n=4000, seed=0):
    r = rng(seed)
    uv = np.c_[r.uniform(0, w, n), r.uniform(0, h, n)].astype(np.float32)
    corners = np.array([[0, 0], [w, 0], [0, h], [w, h]], np.float32)
    return np.concatenate([uv, corners])


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_undistort_points(name):
    args, D = CAMERAS[name]
    uv = _pixels(args[0], args[1])
    with jax.enable_x64(False):
        ref = np.asarray(JaxCamera(*args, D=D).undistort_points(uv))
    cam = PinholeCamera(*args, D=D)
    got = cam.undistort_points(uv)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_PX)
    # a tensor is undistorted on its device and stays a tensor
    got_t = cam.undistort_points(torch.from_numpy(uv))
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), got)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_bounds(name):
    """u_min, u_max, v_min, v_max from the undistorted corners: the
    projection searches read them."""
    args, D = CAMERAS[name]
    with jax.enable_x64(False):
        ref = JaxCamera(*args, D=D)
    cam = PinholeCamera(*args, D=D)
    assert cam.is_distorted == ref.is_distorted
    for k in ("u_min", "u_max", "v_min", "v_max"):
        assert abs(getattr(cam, k) - getattr(ref, k)) <= TOL_PX, k


@pytest.mark.parametrize("name", ["tum_fr1", "tum_fr2", "euroc"])
def test_distort_and_round_trip(name):
    """distort_radtan equals the reference's; distorting the undistorted
    pixels gives back the input as closely in both packages."""
    args, D = CAMERAS[name]
    w, h, fx, fy, cx, cy = args
    uv = _pixels(w, h, seed=1)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    Kt, Dt = torch.from_numpy(K), torch.tensor(D, dtype=torch.float32)
    und = geometry.undistort_pixels(torch.from_numpy(uv), Kt, Dt)
    xy = geometry.pixel_to_normalized(und, Kt)
    back = geometry.distort_radtan(xy, Dt)
    with jax.enable_x64(False):
        import jax.numpy as jnp

        jund = jgeom.undistort_pixels(jnp.asarray(uv), jnp.asarray(K), jnp.asarray(D, jnp.float32))
        jxy = jgeom.pixel_to_normalized(jund, jnp.asarray(K))
        jback = np.asarray(jgeom.distort_radtan(jxy, jnp.asarray(D, jnp.float32)))
    np.testing.assert_allclose(und.numpy(), np.asarray(jund), rtol=0, atol=TOL_PX)
    np.testing.assert_allclose(back.numpy(), jback, rtol=0, atol=TOL_PX / fx)
    back_px = back.numpy() * [fx, fy] + [cx, cy]
    jback_px = jback * [fx, fy] + [cx, cy]
    err, jerr = np.abs(back_px - uv).max(), np.abs(jback_px - uv).max()
    assert err < 0.05 and abs(err - jerr) <= TOL_PX, (err, jerr)


def test_undistorted_camera_is_identity():
    cam = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0)
    uv = _pixels(320, 240, n=10)
    assert not cam.is_distorted
    np.testing.assert_array_equal(cam.undistort_points(uv), uv)
    assert (cam.u_min, cam.u_max, cam.v_min, cam.v_max) == (0.0, 320.0, 0.0, 240.0)
