"""The weight-free extractors of the port against the JAX package:
``ops/patches.py``, SURF, KAZE / AKAZE, Shi-Tomasi, the BRISK / FREAK /
BEBLID descriptors and the cv2 SIFT / RootSIFT wrapper, on seeded
synthetic images.  The reference runs with x64 off, as it runs outside
this suite.

What must be equal, and why the rest has a tolerance:
- keypoints (xy, valid, level, size) and responses of SURF, KAZE, AKAZE
  and Shi-Tomasi: identical.  The port sums the integral image, the
  diffusion steps and the Hessians in the reference's order and with its
  fused multiply-adds (Shi-Tomasi's response within 1e-6, its keypoints
  identical);
- orientations within 1e-3 degrees and float descriptors within 1e-4: the
  two libraries' atan2, sin and cos differ in the last bit;
- AKAZE's 486 M-LDB bits and BEBLID's 512 bits: identical;
- BRISK and FREAK bits: the blur stack convolves in the device's order, not
  in the order of XLA's CPU convolution, so a pair of samples that ties in
  one package can differ by an ulp in the other.  Every differing bit must
  be such a tie (its two samples within 1e-3 grey levels in the port, where
  the median gap is ~30); measured on this frame: 194 of 307200 BRISK bits
  (85 of 600 keypoints) and 671 FREAK bits (111 keypoints); with the
  reference's own blur stack fed in, 75 and 13 (the trigonometry);
- unoriented patches identical; oriented and log-polar patches within
  2e-3 and 4e-3 grey levels (the angle's trigonometry moves the taps);
- SIFT / RootSIFT: cv2 on the host in both packages, identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.features import akaze as jakaze
from pyslam_tpu.features import binary_descriptors as jbin
from pyslam_tpu.features import classical as jclass
from pyslam_tpu.features import surf as jsurf
from pyslam_tpu.features.orb2 import ORB2Extractor as JaxORB2
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.ops import patches as jpatches
from pyslam_tpu_torch.features import akaze as takaze
from pyslam_tpu_torch.features import binary_descriptors as tbin
from pyslam_tpu_torch.features import classical as tclass
from pyslam_tpu_torch.features import surf as tsurf
from pyslam_tpu_torch.ops import patches as tpatches
from tests.torch_parity import np_, rng, synth_image, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)


def noisy_image(seed, h, w):
    r = rng(seed)
    img = synth_image(r, h, w) + r.normal(0, 3, (h, w)).astype(np.float32)
    return np.clip(img, 0, 255).round().astype(np.float32)


def ref_run(fn, *args):
    with jax.enable_x64(False):
        return jax.tree.map(np.asarray, fn(*args))


def circ_deg(a, b):
    return np.abs((np.asarray(a) - np.asarray(b) + 180.0) % 360.0 - 180.0)


def assert_same_keypoints(ref, got):
    v = ref.valid
    assert np.array_equal(np_(got.valid), v)
    assert np.array_equal(np_(got.xy), ref.xy)
    assert np.array_equal(np_(got.level), ref.level)
    assert np.array_equal(np_(got.response), ref.response)
    assert np.array_equal(np_(got.size), ref.size)
    assert circ_deg(np_(got.angle)[v], ref.angle[v]).max() < 1e-3
    assert v.sum() > 50


# ------------------------------------------------------------------ patches
@pytest.mark.parametrize("seed", [0, 1])
def test_patches(seed):
    r = rng(seed)
    img = noisy_image(seed, 96, 128)
    xy = np.stack([r.uniform(-5, 133, 200), r.uniform(-5, 101, 200)], 1).astype(np.float32)
    size = r.uniform(5, 40, 200).astype(np.float32)
    ang = r.uniform(-60, 360, 200).astype(np.float32)
    args = [jnp.asarray(x) for x in (img, xy, size, ang)]
    targs = [t(x) for x in (img, xy, size, ang)]
    flat = np.full_like(ang, -1.0)
    ref = ref_run(jpatches.extract_oriented_patches, *args[:3], jnp.asarray(flat))
    got = np_(tpatches.extract_oriented_patches(*targs[:3], t(flat)))
    assert np.array_equal(got, ref)
    ref = ref_run(jpatches.extract_oriented_patches, *args)
    assert np.abs(np_(tpatches.extract_oriented_patches(*targs)) - ref).max() < 2e-3
    ref = ref_run(jpatches.extract_log_polar_patches, *args)
    assert np.abs(np_(tpatches.extract_log_polar_patches(*targs)) - ref).max() < 4e-3


# --------------------------------------------------------------------- SURF
def test_surf():
    img = noisy_image(0, 240, 320)
    ref = ref_run(jsurf.SurfExtractor(400), img)
    got = tsurf.SurfExtractor(400, device="cpu")(img)
    assert_same_keypoints(ref, got)
    assert np.abs(np_(got.desc) - ref.desc).max() < 1e-4
    assert got.desc.dtype == torch.float32 and got.desc.shape == (400, 64)


# ------------------------------------------------------------- KAZE / AKAZE
@pytest.mark.parametrize("kind", ["KAZE", "MLDB"])
def test_akaze(kind):
    img = noisy_image(1, 96, 128)
    ref = ref_run(jakaze.AkazeExtractor(300, descriptor=kind), img)
    got = takaze.AkazeExtractor(300, descriptor=kind, device="cpu")(img)
    assert_same_keypoints(ref, got)
    if kind == "KAZE":
        assert got.desc.dtype == torch.float32 and got.desc.shape == (300, 64)
        assert np.abs(np_(got.desc) - ref.desc).max() < 1e-4
    else:
        assert got.desc.dtype == torch.int8 and got.desc.shape == (300, 486)
        assert np.array_equal(np_(got.desc), ref.desc)


def test_nonlinear_scale_space():
    img = noisy_image(2, 96, 128)
    # jitted, as the extractor runs it (its fusion decides the rounding)
    ref = ref_run(jax.jit(lambda a: jakaze.nonlinear_scale_space(a / 255.0, 4)[0]),
                  jnp.asarray(img))
    sig_ref = jakaze.nonlinear_scale_space(jnp.zeros((8, 8)), 4)[1]
    got, sig = takaze.nonlinear_scale_space(t(img) * takaze._INV_255, 4)
    assert np.array_equal(np_(got), ref)
    assert np.allclose(sig, sig_ref)


# --------------------------------------------------------------- Shi-Tomasi
def test_shi_tomasi():
    img = noisy_image(3, 240, 320)
    ref = ref_run(jclass.ShiTomasiExtractor(500), img)
    got = tclass.ShiTomasiExtractor(500, device="cpu")(img)
    assert np.array_equal(np_(got.valid), ref.valid)
    assert np.array_equal(np_(got.xy), ref.xy)
    assert np.abs(np_(got.response) - ref.response).max() < 1e-6
    assert ref.valid.sum() > 100


# ------------------------------------------------------ BRISK / FREAK / BEBLID
@pytest.fixture(scope="module")
def orb_keypoints():
    img = np.asarray(JaxSyntheticDataset(num_frames=3).getImage(1), np.float32)
    fd = ref_run(JaxORB2(num_features=600, num_levels=4), img)
    return img, fd.xy, fd.size


@pytest.mark.parametrize("kind,max_flips", [("BRISK", 194), ("FREAK", 671), ("BEBLID", 0)])
def test_binary_descriptors(orb_keypoints, kind, max_flips):
    img, xy, size = orb_keypoints
    jd = jbin.BeblidDescriptor() if kind == "BEBLID" else jbin.PatternBinaryDescriptor(kind)
    td = tbin.BeblidDescriptor() if kind == "BEBLID" else tbin.PatternBinaryDescriptor(kind)
    with jax.enable_x64(False):
        ref = jd.compute(img, xy, size)
    got = np_(td.compute(t(img), t(xy), t(size)))
    assert got.shape == ref.shape == (600, 512) and got.dtype == np.int8
    flips = got != ref
    assert flips.sum() <= max_flips
    if kind != "BEBLID":
        v, _ = td.oriented_samples(t(img), t(xy), t(size))
        gap = np.abs(np_(v)[:, td._pairs[:, 0]] - np_(v)[:, td._pairs[:, 1]])
        assert (gap[flips] < 1e-3).all(), "a differing bit that is not a tie"
        assert np.median(gap) > 10.0


@pytest.mark.parametrize("kind", ["BRISK", "FREAK", "BEBLID"])
def test_binary_described_extractor(kind):
    """The ORB2 detector re-described, as the reference presets compose it;
    level-0 keypoints are bit-exact in both packages, so compare those."""
    img = np.asarray(JaxSyntheticDataset(num_frames=3).getImage(1), np.float32)
    from pyslam_tpu_torch.features.orb2 import ORB2Extractor

    ref = ref_run(jbin.BinaryDescribedExtractor(JaxORB2(num_features=600, num_levels=4), kind),
                  img)
    got = tbin.BinaryDescribedExtractor(
        ORB2Extractor(num_features=600, num_levels=4, device="cpu"), kind)(img)
    lv0 = ref.valid & (ref.level == 0)
    assert np.array_equal(np_(got.xy)[lv0], ref.xy[lv0])
    same = (np_(got.desc)[lv0] == ref.desc[lv0]).mean()
    assert same > (1.0 if kind == "BEBLID" else 0.995) - 1e-12


# ---------------------------------------------------------------- cv2 SIFT
@pytest.mark.parametrize("root", [False, True])
def test_cv_sift(root):
    img = noisy_image(4, 240, 320)
    ref = ref_run(jclass.CvSIFTExtractor(num_features=300, root_sift=root), img)
    got = tclass.CvSIFTExtractor(num_features=300, root_sift=root, device="cpu")(img)
    for f in ("xy", "level", "angle", "size", "response", "desc", "valid"):
        assert np.array_equal(np_(getattr(got, f)), getattr(ref, f)), f
    assert ref.valid.sum() > 50


# ------------------------------------------------------------- LK tracker
def test_lk_tracker():
    """LK_SHI_TOMASI: Shi-Tomasi seeds tracked to a shifted image by the
    tracker's ``track_lk`` in both packages: the same points kept, positions
    within 1e-3 px (test_torch_lk.py's tolerance for the pyramidal LK)."""
    from pyslam_tpu.features.tracker import feature_tracker_factory as jfactory
    from pyslam_tpu_torch.features.tracker import feature_tracker_factory

    img0 = noisy_image(6, 120, 160)
    img1 = np.roll(img0, (2, 3), (0, 1))
    jt = jfactory("LK_SHI_TOMASI")
    tt = feature_tracker_factory("LK_SHI_TOMASI", device="cpu")
    seeds = ref_run(jt.detectAndCompute, img0)
    pts0 = seeds.xy[seeds.valid]
    with jax.enable_x64(False):
        ref = [np.asarray(x) for x in jt.track_lk(img0, img1, pts0)]
    got = tt.track_lk(img0, img1, pts0)
    assert np.array_equal(got[1], ref[1]) and ref[1].sum() > 50
    assert np.abs(got[0] - ref[0])[ref[1]].max() < 1e-3
    np.testing.assert_allclose(got[0][ref[1]], pts0[ref[1]] + [3.0, 2.0], atol=0.1)


@pytest.mark.parametrize("kind", ["BRISK", "BEBLID"])
def test_described_stereo_batch(kind):
    """The batched stereo pair of a described ORB2 extractor equals the
    reference's two passes (each image detected and described apart, then
    row-matched with the matcher's Hamming distance)."""
    from pyslam_tpu_torch.features.orb2 import ORB2Extractor, stereo_match

    ds = JaxSyntheticDataset(num_frames=2)
    left, right = (np.asarray(ds.getImage(1), np.float32),
                   np.asarray(ds.getImageRight(1), np.float32))
    ext = tbin.BinaryDescribedExtractor(ORB2Extractor(num_features=600, num_levels=4,
                                                      device="cpu"), kind)
    args = dict(bf=ds.fx * ds.baseline, max_disp=400.0, max_distance=100.0, row_tol=2.0)
    fl, ur, depth = ext.extract_stereo(left, right, **args)
    ref_l, ref_r = ext(left), ext(right)
    ref_ur, ref_depth = stereo_match(ref_l, ref_r, **args)
    for a, b in zip(fl, ref_l):
        assert torch.equal(a, b)
    assert torch.equal(ur, ref_ur) and torch.equal(depth, ref_depth)
    assert (np_(ur) >= 0).sum() > 100
