"""FAST-9 + 3x3 NMS: the port's plain version (what the CUDA kernel is held
to on the card) against the JAX XLA path and the Pallas kernel in interpret
mode.  Exact equality: every step is a subtraction, min/max, compare or
select on float32."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.ops import fast as jfast
from pyslam_tpu.ops import image as jimage
from pyslam_tpu.ops import pallas_fast
from pyslam_tpu_torch.ops import fast as tfast
from pyslam_tpu_torch.ops import image as timage
from tests.torch_parity import f32, np_, rng, synth_image, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)


def _band_image(r):
    band = pallas_fast.BAND
    h, w = 3 * band + 17, 160
    img = np.full((h, w), 50.0, np.float32)
    for yc in (band, 2 * band - 1, 2 * band):
        img[yc - 4 : yc + 4, 60:80] = 200.0
        img[yc - 4 : yc + 4, 100:120] = 220.0
    return img + r.uniform(0.0, 2.0, (h, w)).astype(np.float32)


def _small_images():
    return {"random_150x200": synth_image(rng(0), h=150, w=200),
            "band_boundaries": _band_image(rng(1))}


def _jax_ref(img, th=20.0):
    return np.asarray(jfast.nms3x3(jfast.fast_score_map(jnp.asarray(f32(img)), th)))


@pytest.mark.parametrize("name", ["random_150x200", "band_boundaries"])
def test_plain_equals_xla_and_pallas(name):
    img = _small_images()[name]
    got = np_(tfast.fast_nms(t(img)[None], 20.0))[0]
    ref = _jax_ref(img)
    assert ref.max() > 0
    assert np.array_equal(got, ref)
    pal = np.asarray(pallas_fast.fast_score_map_pallas(jnp.asarray(f32(img)), 20.0,
                                                       interpret=True))
    assert np.array_equal(got, pal)


@pytest.mark.parametrize("level", [0, 3])
def test_plain_equals_xla_on_kitti_sized_levels(level):
    """Two pyramid levels of a 376x1241 synthetic frame (the main path's
    shapes), the same level image handed to both sides."""
    ds = JaxSyntheticDataset(num_frames=2, h=376, w=1241, fx=718.856, baseline=0.54,
                             trajectory="line", step=0.8)
    lv = np.asarray(jimage.build_pyramid(jnp.asarray(f32(ds.getImage(1))), 4, 1.2)[level])
    got = np_(tfast.fast_nms(t(lv)[None], 20.0))[0]
    ref = _jax_ref(lv)
    assert ref.max() > 0
    assert np.array_equal(got, ref)


def test_batch_equals_per_image():
    imgs = _small_images()["random_150x200"]
    batch = np.stack([imgs, imgs[::-1].copy()])
    got = np_(tfast.fast_nms(t(batch), 20.0))
    for b in range(2):
        assert np.array_equal(got[b], _jax_ref(batch[b]))


def test_score_before_nms_matches_reference():
    img = _small_images()["random_150x200"]
    got = np_(tfast.fast_score_map(t(img), 20.0))
    ref = np.asarray(jfast.fast_score_map(jnp.asarray(f32(img)), 20.0))
    assert np.array_equal(got, ref)


def test_wrapper_rejects_other_devices():
    """The wrapper takes the plain version only for a CPU tensor."""
    x = torch.zeros((1, 32, 32), device="meta")
    with pytest.raises(ValueError):
        tfast.fast_nms(x, 20.0)
    assert tfast.fast_nms.launches == 0


# ------------------------------------------------- the kernel's formulation
def _kernel_mirror(img: torch.Tensor, th: float, border: int = 16) -> torch.Tensor:
    """csrc/fast_nms.cu's arithmetic in PyTorch, for one (H, W) image: the
    per-side compass pretest (the best neighbouring pair of compass points
    past the threshold), the 9-arc extreme of the raw circle values and one
    subtraction, only for the sides that pass, and zero fill outside the
    image.  The kernel takes the extremes on order-preserving int32 keys
    (``test_order_key_preserves_order``), which give the same values."""
    nb = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1)) for dy, dx in tfast.CIRCLE])
    compass = [nb[k] for k in (0, 4, 8, 12)]

    def best_pair(in_pair, across):
        return functools.reduce(across, [in_pair(compass[i], compass[(i + 1) % 4])
                                         for i in range(4)])

    def arc_extreme(in_arc, across):
        r2 = in_arc(nb, torch.roll(nb, -1, 0))
        r4 = in_arc(r2, torch.roll(r2, -2, 0))
        r8 = in_arc(r4, torch.roll(r4, -4, 0))
        return across(in_arc(r8, torch.roll(nb, -8, 0)), 0)

    zero = torch.zeros(())
    h, w = img.shape
    ys, xs = torch.arange(h)[:, None], torch.arange(w)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    bright = arc_extreme(torch.minimum, torch.amax) - img
    dark = img - arc_extreme(torch.maximum, torch.amin)
    bright_passes = best_pair(torch.minimum, torch.maximum) - img > th
    dark_passes = img - best_pair(torch.maximum, torch.minimum) > th
    score = torch.where(inside & bright_passes & (bright > th), bright, zero)
    dark_ok = inside & dark_passes & (dark > th)
    score = torch.where(dark_ok, torch.maximum(score, dark), score)
    p = torch.nn.functional.pad(score, (1, 1, 1, 1))
    neigh = torch.stack([p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)
                         if (dy, dx) != (1, 1)])
    return torch.where(score > torch.amax(neigh, 0), score, zero)


def _mirror_images():
    imgs = _small_images()
    ds = JaxSyntheticDataset(num_frames=2, h=376, w=1241, fx=718.856, baseline=0.54,
                             trajectory="line", step=0.8)
    pyr = jimage.build_pyramid(jnp.asarray(f32(ds.getImage(1))), 8, 1.2)
    imgs["kitti_level1"] = np.asarray(pyr[1])
    imgs["kitti_level6"] = np.asarray(pyr[6])
    # many ties: 8 grey levels
    imgs["ties_8_levels"] = np.floor(rng(7).uniform(0, 8, (120, 160))).astype(np.float32) * 32.0
    return imgs


@pytest.mark.parametrize("name", ["random_150x200", "band_boundaries", "kitti_level1",
                                  "kitti_level6", "ties_8_levels"])
def test_kernel_formulation_equals_reference(name):
    """The per-side compass pretest, doubling and the hoisted subtraction
    give the reference's result bit for bit (the kernel does only these
    steps)."""
    img = _mirror_images()[name]
    ref = _jax_ref(img)
    got = np_(_kernel_mirror(t(img), 20.0))
    assert ref.max() > 0
    assert np.array_equal(got, ref)


def test_pyramid_equals_levels_on_cpu():
    """On CPU tensors ``fast_nms_pyramid`` is the plain version level by
    level, and counts no launch."""
    imgs = np.stack([synth_image(rng(8), h=150, w=200), synth_image(rng(9), h=150, w=200)])
    pyr = timage.build_pyramid(t(imgs), 4, 1.2)
    before = tfast.fast_nms.launches
    got = tfast.fast_nms_pyramid(pyr, 20.0)
    assert len(got) == 4 and tfast.fast_nms.launches == before
    for lv, (x, y) in enumerate(zip(pyr, got)):
        assert torch.equal(y, tfast.fast_nms_plain(x, 20.0)), lv
    assert int((got[0] > 0).sum()) > 0


def test_pyramid_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        tfast.fast_nms_pyramid([], 20.0)
    with pytest.raises(ValueError):
        tfast.fast_nms_pyramid([torch.zeros((1, 32, 32), device="meta")], 20.0)
    with pytest.raises(ValueError):   # one level on the CPU, one elsewhere
        tfast.fast_nms_pyramid([torch.zeros((1, 32, 32)),
                                torch.zeros((1, 32, 32), device="meta")], 20.0)
    assert tfast.fast_nms.launches == 0


def _order_key(x: np.ndarray) -> np.ndarray:
    """csrc/fast_nms.cu's order_key on float32 bit patterns."""
    bits = x.astype(np.float32).view(np.int32)
    return bits ^ ((bits >> 31) & np.int32(0x7FFFFFFF))


def test_order_key_preserves_order():
    """min and max on the kernel's int32 keys are min and max on the floats,
    and the key is its own inverse."""
    r = rng(12)
    x = np.concatenate([r.uniform(-300, 300, 4000), r.uniform(0, 255, 4000),
                        [0.0, -0.0, 1e-30, -1e-30, 255.0, np.float32(3.4e38)]]).astype(np.float32)
    k = _order_key(x)
    assert np.array_equal(_order_key(k.view(np.float32)).view(np.float32).view(np.int32),
                          x.view(np.int32))
    a, b = x[:4000], x[4000:8000]
    ka, kb = k[:4000], k[4000:8000]
    assert np.array_equal(np.where(ka < kb, a, b), np.minimum(a, b))
    assert np.array_equal(np.where(ka > kb, a, b), np.maximum(a, b))
    nz = x != 0
    assert np.array_equal(np.argsort(k[nz], kind="stable"), np.argsort(x[nz], kind="stable"))
