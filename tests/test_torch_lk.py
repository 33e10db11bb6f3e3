"""Pyramidal Lucas-Kanade of the port against the JAX package
(``ops/lk.py``, ``ops/image.py::sobel_gradients``, ``bilinear_sample`` and
the LK pyramid), on the same seeded numpy images, the reference with x64
off as it runs outside this suite.

Tolerances: Sobel gradients within 2 float32 ulps of the magnitude of their
partial sums (4 x the largest grey level) of the reference's convolution,
whose summation order is XLA's (identical on integer images); bilinear
samples identical; LK points within 1e-3 px where both say ok, ok masks
identical; the scale-2 pyramid within 1e-4 grey levels, as
test_torch_image.py holds the ORB pyramid (the column pass's accepted
deviation, ROADMAP.md section 3; 2**-15 = 3.05e-5 measured)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import rng, synth_image

from pyslam_tpu.ops import fast as jfast, image as jimage, lk as jlk, nms as jnms
from pyslam_tpu_torch.ops import image, lk

PTS_TOL_PX = 1e-3
PYR_TOL = 1e-4


def _pair(seed=0, h=256, w=320, dy=3, dx=-5):
    base = synth_image(rng(seed), h, w)
    img0 = base[8:-8, 8:-8]
    img1 = base[8 + dy:h - 8 + dy, 8 + dx:w - 8 + dx]
    return np.ascontiguousarray(img0), np.ascontiguousarray(img1)


def _corners(img, n=200):
    with jax.enable_x64(False):
        score = jfast.nms3x3(jfast.fast_score_map(jnp.asarray(img), 20.0))
        xy, _, valid = jnms.grid_topk_keypoints(score, 16, 4, n)
    return np.asarray(xy)[np.asarray(valid)]


@pytest.mark.parametrize("integer", [True, False])
def test_sobel_gradients(integer):
    img, _ = _pair(1)
    if integer:
        img = np.round(img)
    with jax.enable_x64(False):
        rgx, rgy = (np.asarray(g) for g in jimage.sobel_gradients(jnp.asarray(img)))
    gx, gy = (g.numpy() for g in image.sobel_gradients(torch.from_numpy(img)))
    if integer:
        np.testing.assert_array_equal(gx, rgx)
        np.testing.assert_array_equal(gy, rgy)
    else:
        ulp = np.spacing(np.float32(4 * np.abs(img).max()))
        assert np.abs(gx - rgx).max() <= 2 * ulp and np.abs(gy - rgy).max() <= 2 * ulp


def test_bilinear_sample():
    img, _ = _pair(2)
    r = rng(2)
    h, w = img.shape
    # inside, on the clamp borders and outside the image
    xy = np.c_[r.uniform(-5, w + 5, 3000), r.uniform(-5, h + 5, 3000)].astype(np.float32)
    xy[:10] = [[0, 0], [w - 1, h - 1], [w - 1.001, 0], [w, h], [-1, -1], [0.5, h - 1.0005],
               [w - 1.5, 3.25], [10, 10], [w + 100, -100], [3.999, 7.001]]
    with jax.enable_x64(False):
        ref = np.asarray(jimage.bilinear_sample(jnp.asarray(img * 1.37), jnp.asarray(xy)))
    got = image.bilinear_sample(torch.from_numpy(img * 1.37), torch.from_numpy(xy)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", [(376, 1241), (240, 304), (120, 160)])
def test_lk_pyramid_levels(hw):
    """build_pyramid(img, 3, 2.0) at the LK shapes: 376x1241 -> 188x620 ->
    94x310 (the bench frame), and the test images."""
    img = synth_image(rng(hw[1]), *hw, n_blobs=max(20, hw[0] // 3))
    with jax.enable_x64(False):
        ref = [np.asarray(x) for x in jimage.build_pyramid(jnp.asarray(img), 3, 2.0)]
    got = [x.numpy() for x in image.build_pyramid(torch.from_numpy(img), 3, 2.0)]
    for lv, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, (lv, a.shape, b.shape)
        assert np.abs(a - b).max() <= PYR_TOL, (lv, np.abs(a - b).max())


@pytest.mark.parametrize("shift", [(3, -5), (-2, 4), (6, 6)])
def test_lk_track_pyramidal(shift):
    img0, img1 = _pair(0, dy=shift[0], dx=shift[1])
    pts0 = _corners(img0)
    with jax.enable_x64(False):
        rp, rok, rres = (np.asarray(x) for x in jlk.lk_track_pyramidal(
            jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts0)))
    p, ok, res = (x.numpy() for x in lk.lk_track_pyramidal(
        torch.from_numpy(img0), torch.from_numpy(img1), torch.from_numpy(pts0)))
    np.testing.assert_array_equal(ok, rok)
    both = ok & rok
    assert both.sum() > 50
    np.testing.assert_allclose(p[both], rp[both], rtol=0, atol=PTS_TOL_PX)
    np.testing.assert_allclose(res[both], rres[both], rtol=1e-4, atol=1e-4)
    # and the flow is the shift (the reference's own floor)
    med = np.median(p[ok] - pts0[ok], axis=0)
    np.testing.assert_allclose(med, [-shift[1], -shift[0]], atol=0.5)


def test_lk_flow_level_masks():
    """One level from a displaced guess: the det > 1e-4 and border masks and
    the residual as the reference computes them (flat patches fail the
    conditioning test, points near the border leave the image)."""
    img0, img1 = _pair(3)
    img0[100:140, 100:140] = 90.0            # a flat patch: det == 0
    img1[100:140, 100:140] = 90.0
    pts = np.concatenate([_corners(img0, 100),
                          np.array([[120, 120], [3, 50], [img0.shape[1] - 4, 60]],
                                   np.float32)]).astype(np.float32)
    guess = pts + np.float32(1.5)
    with jax.enable_x64(False):
        rp, rok, rres = (np.asarray(x) for x in jlk.lk_flow_level(
            jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), jnp.asarray(guess)))
    p, ok, res = (x.numpy() for x in lk.lk_flow_level(
        torch.from_numpy(img0), torch.from_numpy(img1), torch.from_numpy(pts),
        torch.from_numpy(guess)))
    np.testing.assert_array_equal(ok, rok)
    assert not ok[-3:].any()
    np.testing.assert_allclose(p[ok], rp[ok], rtol=0, atol=PTS_TOL_PX)
    np.testing.assert_allclose(res, rres, rtol=1e-4, atol=1e-4)
