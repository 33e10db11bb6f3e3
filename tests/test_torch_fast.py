"""FAST-9 + 3x3 NMS: the port's plain version (what the CUDA kernel is held
to on the card) against the JAX XLA path and the Pallas kernel in interpret
mode.  Exact equality: every step is a subtraction, min/max, compare or
select on float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.ops import fast as jfast
from pyslam_tpu.ops import image as jimage
from pyslam_tpu.ops import pallas_fast
from pyslam_tpu_torch.ops import fast as tfast
from tests.torch_parity import f32, np_, rng, synth_image, t


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
