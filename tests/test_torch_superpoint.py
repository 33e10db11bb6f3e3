"""SuperPoint in the port (pyslam_tpu_torch/models/superpoint.py) against
the JAX package's, with the bundled weights carried across
(``interop.superpoint_state_dict``), and the quality floors of
tests/test_superpoint_trained.py on the port.

Tolerances: the detector logits and descriptor maps within 1e-4 absolute
(float32 convolutions summed in another order); keypoints identical,
responses and descriptors within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models.superpoint import SuperPointExtractor as JaxSuperPoint
from pyslam_tpu.models.train_superpoint import (
    H,
    W,
    random_homography,
    render_shapes,
    warp_image,
    warp_points,
)
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models.superpoint import SuperPointExtractor
from tests.torch_parity import np_, rng, synth_image

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64(False):
        ref = JaxSuperPoint(num_features=300)
    return ref, SuperPointExtractor(num_features=300, device="cpu")


def test_bundled_weights_are_carried_across(pair):
    ref, got = pair
    assert ref.trained and got.trained
    sd = got.net.state_dict()
    for i, name in enumerate(interop.SUPERPOINT_CONVS):
        k = np.asarray(ref.params["params"][f"Conv_{i}"]["kernel"])
        assert np.array_equal(np_(sd[f"{name}.weight"]), k.transpose(3, 2, 0, 1)), name
        assert np.array_equal(np_(sd[f"{name}.bias"]),
                              np.asarray(ref.params["params"][f"Conv_{i}"]["bias"])), name


def test_net_maps(pair):
    """Detector logits (65, 15, 20) and descriptor map (256, 15, 20) of a
    120x160 image against ``SuperPointNet.apply``."""
    ref, got = pair
    img = synth_image(rng(3), 120, 160)
    with jax.enable_x64(False):
        det, desc = ref.net.apply(ref.params, jnp.asarray(img)[..., None] / 255.0)
    with torch.no_grad():
        det_t, desc_t = got.net(torch.from_numpy(img)[None, None] / 255.0)
    assert det_t.shape == (1, 65, 15, 20) and desc_t.shape == (1, 256, 15, 20)
    assert np.abs(np_(det_t[0]).transpose(1, 2, 0) - np.asarray(det)).max() <= TOL
    assert np.abs(np_(desc_t[0]).transpose(1, 2, 0) - np.asarray(desc)).max() <= TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_extractor(pair, seed):
    """Keypoints, responses and descriptors of a 120x163 image (cropped to
    120x160 by both) against the JAX extractor."""
    ref, got = pair
    img = np.round(synth_image(rng(seed), 120, 163))
    with jax.enable_x64(False):
        fr = ref(img)
        prob_det, _ = ref.net.apply(ref.params, jnp.asarray(img[:, :160])[..., None] / 255.0)
    fg = got(img)
    assert fg.xy.device.type == "cpu" and fg.desc.shape == (300, 256)
    valid = np.asarray(fr.valid)
    assert np.array_equal(np_(fg.valid), valid) and valid.sum() > 50
    assert np.array_equal(np_(fg.xy), np.asarray(fr.xy))
    assert np.abs(np_(fg.response) - np.asarray(fr.response)).max() <= TOL
    assert np.abs(np_(fg.desc)[valid] - np.asarray(fr.desc)[valid]).max() <= TOL
    assert (np_(fg.level) == 0).all() and (np_(fg.size) == 8.0).all()
    assert (np_(fg.angle) == 0.0).all()
    # the unfolded probability map: the reference's (hc, wc, 8, 8) order
    prob, _ = got.maps(torch.from_numpy(img.astype(np.float32)))
    p = np.asarray(jax.nn.softmax(prob_det, axis=-1))[..., :64]
    p = p.reshape(15, 20, 8, 8).transpose(0, 2, 1, 3).reshape(120, 160)
    assert np.abs(np_(prob) - p).max() <= TOL


def test_official_checkpoint_loads_in_both(tmp_path):
    """A MagicLeap-layout ``superpoint_v1.pth`` (conv1a..convDb, random
    weights written here) loads into both packages, which then agree."""
    g = torch.Generator().manual_seed(5)
    shapes = {"conv1a": (64, 1), "conv1b": (64, 64), "conv2a": (64, 64), "conv2b": (64, 64),
              "conv3a": (128, 64), "conv3b": (128, 128), "conv4a": (128, 128),
              "conv4b": (128, 128), "convPa": (256, 128), "convPb": (65, 256),
              "convDa": (256, 128), "convDb": (256, 256)}
    sd = {}
    for name, (o, i) in shapes.items():
        k = 1 if name in ("convPb", "convDb") else 3
        sd[f"{name}.weight"] = torch.randn(o, i, k, k, generator=g) * (2.0 / (i * k * k)) ** 0.5
        sd[f"{name}.bias"] = torch.randn(o, generator=g) * 0.01
    path = str(tmp_path / "superpoint_v1.pth")
    torch.save(sd, path)
    img = np.round(synth_image(rng(7), 96, 128))
    with jax.enable_x64(False):
        ref = JaxSuperPoint(num_features=200, checkpoint=path)
        fr = ref(img)
    got = SuperPointExtractor(num_features=200, checkpoint=path, device="cpu")
    assert got.trained and ref.trained
    fg = got(img)
    valid = np.asarray(fr.valid)
    assert np.array_equal(np_(fg.valid), valid) and valid.sum() > 0
    assert np.array_equal(np_(fg.xy)[valid], np.asarray(fr.xy)[valid])
    assert np.abs(np_(fg.desc)[valid] - np.asarray(fr.desc)[valid]).max() <= TOL


def test_missing_checkpoint_falls_back_to_seeded_random(monkeypatch, tmp_path):
    """Without the bundled file the extractor reports ``trained = False``
    and its random weights come from a seeded generator (two builds
    equal)."""
    monkeypatch.setattr(interop, "CHECKPOINT_DIR", tmp_path)
    a = SuperPointExtractor(num_features=50, device="cpu")
    b = SuperPointExtractor(num_features=50, device="cpu")
    assert not a.trained and not b.trained
    for (k, va), vb in zip(a.net.state_dict().items(), b.net.state_dict().values()):
        assert torch.equal(va, vb), k


# ---------------------------------------------- tests/test_superpoint_trained.py
def _held_out_scene(seed):
    r = np.random.default_rng(seed)
    img, corners = render_shapes(r)
    while len(corners) < 8:
        img, corners = render_shapes(r)
    return img, corners


def _detect(ex, img, k):
    fd = ex(img)
    xy, resp, valid = np_(fd.xy), np_(fd.response), np_(fd.valid)
    order = np.argsort(-np.where(valid, resp, -np.inf))[:k]
    return xy[order], np_(fd.desc)[order]


def _corner_precision(xy, corners, tol=4.0):
    d = np.linalg.norm(xy[:, None, :] - corners[None, :, :], axis=-1)
    return float((d.min(axis=1) <= tol).mean())


def test_trained_detector_localizes_corners():
    """Corner precision of the 40 best keypoints on a held-out scene:
    >= 0.5, and >= the random net's + 0.2."""
    img, corners = _held_out_scene(12345)
    prec = _corner_precision(_detect(SuperPointExtractor(300, device="cpu"), img, 40)[0],
                             corners)
    raw = SuperPointExtractor(300, device="cpu")
    interop.seeded_init_(raw.net, 3)
    prec_r = _corner_precision(_detect(raw, img, 40)[0], corners)
    assert prec >= 0.5, f"trained corner precision {prec:.2f} < 0.5"
    assert prec >= prec_r + 0.2, (prec, prec_r)


def test_trained_descriptors_match_across_homography():
    """Mutual nearest neighbours of the 80 best keypoints across a random
    homography: at least half within 6 px of the warped keypoint."""
    img, _ = _held_out_scene(54321)
    Hm = random_homography(np.random.default_rng(7))
    ex = SuperPointExtractor(300, device="cpu")
    xy1, d1 = _detect(ex, img, 80)
    xy2, d2 = _detect(ex, warp_image(img, Hm), 80)
    sim = d1 @ d2.T
    a2b, b2a = sim.argmax(1), sim.argmax(0)
    mutual = b2a[a2b] == np.arange(len(xy1))
    proj = warp_points(xy1, Hm)
    in_view = (proj[:, 0] >= 0) & (proj[:, 0] < W) & (proj[:, 1] >= 0) & (proj[:, 1] < H)
    sel = mutual & in_view
    assert sel.sum() >= 10, int(sel.sum())
    inlier_frac = float((np.linalg.norm(xy2[a2b[sel]] - proj[sel], axis=1) <= 6.0).mean())
    assert inlier_frac >= 0.5, inlier_frac
