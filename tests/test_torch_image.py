"""Pyramid and blur of the port against ``pyslam_tpu.ops.image``.

The pyramid is held to the JAX package as it runs outside this test suite,
with x64 off: ``jax.image.resize`` builds its weights in the type of its
Python-scalar scale, so float32 there and float64 under the suite's x64.
Every reference that passes through the resize runs under
``jax.enable_x64(False)``.

Tolerances: the weights and the row pass are identical; the column pass
sums in a fixed order of its own (XLA's CPU matrix product interleaves 2 or
4 accumulators by a rule that depends on the shape), so levels agree to
1e-4 grey levels (3.05e-5 measured at 376x1241 by tests/torch_pyramid_gap.py),
with up to about half of the pixels an ulp apart at the coarsest levels.
The blur uses the same taps, summation order and fused multiply-adds as the
reference's compiled shift-and-add, so it is identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src.image import scale as jscale

from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.ops import image as jimage
from pyslam_tpu_torch.ops import image as timage
from tests.torch_parity import f32, np_, rng, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

# (input, output) sizes of the resize on the main path (376x1241, 8
# levels) and in the parity tests (240x320)
_SIZES = sorted({(n, timage.level_shape(376, 1241, 1.2, lv)[i])
                 for lv in range(1, 8) for i, n in enumerate((376, 1241))}
                | {(n, timage.level_shape(240, 320, 1.2, lv)[i])
                   for lv in range(1, 8) for i, n in enumerate((240, 320))})


@pytest.fixture(scope="module")
def kitti_frame():
    ds = JaxSyntheticDataset(num_frames=2, h=376, w=1241, fx=718.856, baseline=0.54,
                             trajectory="line", step=0.8)
    return f32(ds.getImage(1))


def _jax_pyramid(img, levels):
    with jax.enable_x64(False):
        return [np.asarray(p) for p in
                jax.jit(lambda im: jimage.build_pyramid(im, levels, 1.2))(jnp.asarray(img))]


@pytest.mark.parametrize("n, m", _SIZES)
def test_resize_weights_bit_equal_x64_off(n, m):
    """The port's weights are those of ``compute_weight_mat`` compiled with
    x64 off, and those ``jax.image.resize`` applies (read back by resizing
    an identity matrix)."""
    with jax.enable_x64(False):
        ref = np.asarray(jax.jit(lambda: jscale.compute_weight_mat(
            n, m, m / n, 0.0, jscale._fill_triangle_kernel, True))())
        applied = np.asarray(jax.jit(lambda x: jax.image.resize(x, (n, m), "bilinear"))(
            jnp.eye(n, dtype=jnp.float32)))
    got = timage.resize_weights(n, m).T
    assert ref.dtype == np.float32
    assert np.array_equal(got, ref)
    assert np.array_equal(got, applied)


def test_x64_changes_the_reference_weights():
    """Why the references run with x64 off: with x64 on the weights are
    built in float64 and differ from the package's own."""
    n, m = 1241, 1034
    with jax.enable_x64(True):
        w64 = np.asarray(jax.jit(lambda x: jax.image.resize(x, (n, m), "bilinear"))(
            jnp.eye(n, dtype=jnp.float32)))
    assert not np.array_equal(timage.resize_weights(n, m).T, w64)


def test_row_pass_bit_equal(kitti_frame):
    """The first contraction of the resize, as its einsum compiles it (a
    dot over axis 0 of the weights and the image), is identical at every
    level of a 376x1241 frame."""
    h, w = kitti_frame.shape
    with jax.enable_x64(False):
        for lv in range(1, 8):
            hh, _ = timage.level_shape(h, w, 1.2, lv)
            wh = timage.resize_weights(h, hh).T.copy()
            ref = np.asarray(jax.jit(lambda a, b: jax.lax.dot_general(
                a, b, (((0,), (0,)), ((), ())), precision="highest"))(
                    jnp.asarray(wh), jnp.asarray(kitti_frame)))
            got = np_(timage._resize_axis(t(kitti_frame), hh, 0, timage.depth_panel(h)))
            assert np.array_equal(got, ref), lv


def test_pyramid_matches_jax_resize(kitti_frame):
    ref = _jax_pyramid(kitti_frame, 8)
    got = timage.build_pyramid(t(kitti_frame), 8, 1.2)
    assert len(got) == 8
    for lv, (a, b) in enumerate(zip(ref, got)):
        b = np_(b)
        assert a.shape == b.shape, lv
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=f"level {lv}")
        # the column pass's order: an ulp on at most half of the pixels
        assert np.mean(a != b) <= 0.5, lv
    assert np.array_equal(np_(got[0]), ref[0])


def test_pyramid_of_random_image():
    img = np.floor(rng(3).uniform(0, 255, (120, 170))).astype(np.float32)
    ref = _jax_pyramid(img, 5)
    got = timage.build_pyramid(t(img), 5, 1.2)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np_(b), a, rtol=0, atol=1e-4)


def test_pyramid_batch_equals_single():
    img = np.floor(rng(4).uniform(0, 255, (2, 90, 130))).astype(np.float32)
    both = timage.build_pyramid(t(img), 4, 1.2)
    for b in range(2):
        one = timage.build_pyramid(t(img[b]), 4, 1.2)
        for x, y in zip(both, one):
            assert np.array_equal(np_(x[b]), np_(y))


@pytest.mark.parametrize("depth, panel", [(240, 240), (320, 320), (328, 328), (336, 168),
                                          (376, 192), (600, 304), (700, 240)])
def test_depth_panel(depth, panel):
    assert timage.depth_panel(depth) == panel


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
