"""Pyramid and blur of the port against ``pyslam_tpu.ops.image``.

Tolerances: the pyramid reproduces jax.image.resize's antialiased weights
but sums in a fixed order of its own, so levels agree to float32 rounding
(1e-3 grey levels); the blur uses the same taps, summation order and
fused multiply-adds as the reference's compiled shift-and-add, so it is
identical."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.ops import image as jimage
from pyslam_tpu_torch.ops import image as timage
from tests.torch_parity import f32, np_, rng, t


@pytest.fixture(scope="module")
def kitti_frame():
    ds = JaxSyntheticDataset(num_frames=2, h=376, w=1241, fx=718.856, baseline=0.54,
                             trajectory="line", step=0.8)
    return f32(ds.getImage(1))


def test_pyramid_matches_jax_resize(kitti_frame):
    ref = jimage.build_pyramid(jnp.asarray(kitti_frame), 8, 1.2)
    got = timage.build_pyramid(t(kitti_frame), 8, 1.2)
    assert len(got) == 8
    for lv, (a, b) in enumerate(zip(ref, got)):
        a, b = np.asarray(a), np_(b)
        assert a.shape == b.shape, lv
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3, err_msg=f"level {lv}")


def test_pyramid_of_random_image():
    img = np.floor(rng(3).uniform(0, 255, (120, 170))).astype(np.float32)
    ref = jimage.build_pyramid(jnp.asarray(img), 5, 1.2)
    got = timage.build_pyramid(t(img), 5, 1.2)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np_(b), np.asarray(a), rtol=0, atol=1e-3)


def test_pyramid_batch_equals_single():
    img = np.floor(rng(4).uniform(0, 255, (2, 90, 130))).astype(np.float32)
    both = timage.build_pyramid(t(img), 4, 1.2)
    for b in range(2):
        one = timage.build_pyramid(t(img[b]), 4, 1.2)
        for x, y in zip(both, one):
            assert np.array_equal(np_(x[b]), np_(y))


@pytest.mark.parametrize("shape", [(376, 1241), (105, 346)])
def test_gaussian_blur(shape):
    img = rng(5).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img), 2.0, 3))
    got = np_(timage.gaussian_blur(t(img), 2.0, 3))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0])
def test_gaussian_taps(sigma):
    ref = np.asarray(jimage.gaussian_kernel1d(sigma, 3))
    assert np.array_equal(timage.gaussian_kernel1d(sigma, 3), ref)


def test_gaussian_blur_batch_equals_single():
    img = rng(6).uniform(0, 255, (2, 60, 90)).astype(np.float32)
    both = np_(timage.gaussian_blur(t(img), 2.0, 3))
    for b in range(2):
        assert np.array_equal(both[b], np_(timage.gaussian_blur(t(img[b]), 2.0, 3)))

