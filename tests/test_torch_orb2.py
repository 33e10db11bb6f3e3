"""ORB2 extraction of the port against ``pyslam_tpu.features.orb2`` on a
240x320 synthetic stereo frame (600 features, 4 levels).

The reference runs with x64 off, as the JAX package runs outside this
suite: its resize builds the pyramid's weights in the type of a Python
scalar, float64 under the suite's x64 (see test_torch_image.py).

What must be equal, and why the rest has a tolerance:
- fed the reference's own pyramid, the port's per-level extraction gives
  identical keypoints (xy, level, size, response, valid) and descriptor
  bits at every level, with x64 off and on; angles agree within 1e-4
  degrees (atan2 of two libraries), which leaves every orientation bin the
  same;
- level 0 reads the input image itself, so with the port's own pyramid its
  keypoints and descriptor bits are identical too;
- levels >= 1 of the port's own pyramid have the reference's weights and
  row pass bit for bit, but XLA's CPU matrix product sums the column pass
  with 2 or 4 interleaved accumulators by a rule that depends on the shape,
  which the port does not follow: an ulp on up to half of the pixels, and
  a score or a pair of BRIEF pixels that ties in one package can differ in
  the other.  Measured here: 99.5 % of the keypoints identical, 99.85 % of
  the descriptor bits of the shared keypoints (one descriptor in ten with a
  flipped bit); the floors are 99 % each;
- right-image u and depth agree within 1e-4 relative wherever both
  packages matched the keypoint to the same right keypoint (95.1 % of the
  keypoints either matched, floor 95 %).
"""

import jax
import numpy as np
import pytest

from pyslam_tpu.features.orb2 import ORB2Extractor as JaxORB2
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.ops import image as jimage
from pyslam_tpu.ops.orb import _make_pattern
from pyslam_tpu_torch.features.orb2 import ORB2Extractor, extract_pyramid, level_quotas
from pyslam_tpu_torch.ops import orb as torb
from tests.torch_parity import f32, np_, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

NF, NL = 600, 4
STEREO = dict(bf=200.0 * 0.2, max_disp=400.0, max_distance=100.0, row_tol=2.0)


@pytest.fixture(scope="module")
def frame():
    ds = JaxSyntheticDataset(num_frames=3)
    return f32(ds.getImage(1)), f32(ds.getImageRight(1))


@pytest.fixture(scope="module")
def single(frame):
    with jax.enable_x64(False):
        ref = jax.tree.map(np.asarray, JaxORB2(num_features=NF, num_levels=NL)(frame[0]))
    got = [np_(x) for x in ORB2Extractor(num_features=NF, num_levels=NL, device="cpu")(frame[0])]
    return ref, got


@pytest.fixture(scope="module")
def stereo(frame):
    with jax.enable_x64(False):
        meta, desc = JaxORB2(num_features=NF, num_levels=NL).extract_stereo_deferred(
            frame[0], frame[1], **STEREO)
        meta, desc = np.asarray(meta), np.asarray(desc)
    fl, ur, depth = ORB2Extractor(num_features=NF, num_levels=NL, device="cpu").extract_stereo(
        frame[0], frame[1], **STEREO)
    return np.asarray(meta), np.asarray(desc), fl, np_(ur), np_(depth)


def _same(ref, got):
    return np.all(ref.xy == got[0], 1) & (ref.level == got[1])


def test_pattern_equals_reference():
    assert np.array_equal(torb.PATTERN, _make_pattern())


def test_level0_identical(single):
    ref, got = single
    lv0 = ref.level == 0
    assert lv0.sum() == level_quotas(NF, NL, 1.2)[0]
    for i, field in ((0, "xy"), (1, "level"), (4, "response"), (6, "valid"), (5, "desc")):
        assert np.array_equal(got[i][lv0], getattr(ref, field)[lv0]), field


def _on_pyramid(img, x64):
    """The port's per-level extraction of ``img``, fed the pyramid that the
    reference builds (compiled, as inside its extractor)."""
    with jax.enable_x64(x64):
        pyr = jax.jit(lambda im: jimage.build_pyramid(im, NL, 1.2))(img)
    ex = ORB2Extractor(num_features=NF, num_levels=NL, device="cpu")
    got = extract_pyramid([t(np.asarray(p))[None] for p in pyr], ex.num_features,
                          ex.scale_factor, float(ex.fast_threshold), ex.cell, ex.per_cell)
    return [np_(x[0]) for x in got]


@pytest.fixture(scope="module")
def on_reference_pyramid(frame):
    return _on_pyramid(frame[0], False)


@pytest.mark.parametrize("i, field", [(0, "xy"), (1, "level"), (3, "size"), (4, "response"),
                                      (5, "desc"), (6, "valid")])
def test_levels_identical_on_reference_pyramid(single, on_reference_pyramid, i, field):
    ref, _ = single
    assert np.array_equal(on_reference_pyramid[i], getattr(ref, field)), field


def test_levels_identical_on_reference_pyramid_x64_on(frame):
    """The per-level logic does not depend on how the pyramid was made: with
    x64 on too, the port fed the reference's pyramid is identical."""
    with jax.enable_x64(True):
        ref = jax.tree.map(np.asarray, JaxORB2(num_features=NF, num_levels=NL)(frame[0]))
    got = _on_pyramid(frame[0], True)
    for i, field in ((0, "xy"), (1, "level"), (3, "size"), (4, "response"), (5, "desc"),
                     (6, "valid")):
        assert np.array_equal(got[i], getattr(ref, field)), field


def test_angles_on_reference_pyramid(single, on_reference_pyramid):
    ref, _ = single
    diff = np.abs(on_reference_pyramid[2] - ref.angle)
    assert np.minimum(diff, 360.0 - diff).max() <= 1e-4


def test_all_levels_keypoints(single):
    ref, got = single
    same = _same(ref, got)
    assert same.mean() >= 0.99, same.mean()
    assert np.array_equal(got[6], ref.valid)


def test_descriptor_bits(single):
    ref, got = single
    same = _same(ref, got) & ref.valid
    bits_equal = got[5][same] == ref.desc[same]
    assert bits_equal.mean() >= 0.99, bits_equal.mean()


def test_orientation_bins(single):
    ref, got = single
    same = _same(ref, got)
    step = 360.0 / torb.ANGLE_BINS
    b_ref = np.round(ref.angle[same] / step) % torb.ANGLE_BINS
    b_got = np.round(got[2][same] / step) % torb.ANGLE_BINS
    assert (b_ref == b_got).mean() >= 0.99
    np.testing.assert_allclose(got[3], ref.size, rtol=1e-6)


def test_stereo_left_features(stereo):
    meta, desc, fl, _, _ = stereo
    xy = np_(fl.xy)
    lv0 = meta[:, 2] == 0
    assert np.array_equal(xy[lv0], meta[lv0, 0:2])
    assert np.array_equal(np_(fl.desc)[lv0], desc[lv0])
    assert (np.all(xy == meta[:, 0:2], 1)).mean() >= 0.99


def test_stereo_depth(stereo):
    meta, _, _, ur, depth = stereo
    ref_ur, ref_depth = meta[:, 7], meta[:, 8]
    both = (ur >= 0) & (ref_ur >= 0) & (ur == ref_ur)
    assert both.sum() > 0.3 * len(ur)
    # identical matches on >= 95 % of the keypoints either package matched
    either = (ur >= 0) | (ref_ur >= 0)
    assert both.sum() >= 0.95 * either.sum()
    np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-4)
    assert np.all(depth[ur < 0] == -1.0)
