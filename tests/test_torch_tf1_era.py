"""LF-Net, DELF and ContextDesc in the port (pyslam_tpu_torch/models/
{lfnet,delf,contextdesc}.py) against the JAX package's extractors on the
96x128 image of tests/test_tf1_era_features.py, with the JAX package's
``PRNGKey(0)`` weights carried across (``interop``), and their ``.npz``
checkpoints (the JAX package's ``save_variables_npz`` layout) read by path.
ContextDesc re-describes cv2 SIFT's keypoints of that image, every slot.

Tolerances: the network's maps within 1e-4 of their largest magnitude;
keypoints identical; responses, sizes and descriptors within 1e-4, LF-Net's
angles within 1e-3 degrees (float32 atan2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models import contextdesc as jctx
from pyslam_tpu.models import delf as jdelf
from pyslam_tpu.models import lfnet as jlfnet
from pyslam_tpu.models.torch_convert import save_variables_npz
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import contextdesc, delf, lfnet
from tests.torch_parity import (
    assert_same_features,
    compiled_flax_init,
    flat_variables,
    np_,
    rel_err,
    rng,
)
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-4
N = 400


@pytest.fixture(scope="module")
def img():
    """The image of tests/test_tf1_era_features.py."""
    r = np.random.default_rng(0)
    im = r.uniform(0, 128, (96, 128)).astype(np.float32)
    im[30:60, 40:80] += 100
    im[10:20, 90:110] += 80
    return np.clip(im, 0, 255)


def _same_state(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def _wrapped(a, b, period):
    d = np.abs(np_(a) - np.asarray(b)) % period
    return np.minimum(d, period - d).max()


def test_lfnet(img, tmp_path):
    with jax.enable_x64(False), compiled_flax_init():
        ref = jlfnet.LFNetExtractor(num_features=N)
    with jax.enable_x64(False):
        score, scale, angle = jax.jit(ref.det.apply)(ref.det_params, jnp.asarray(img) / 255.0)
        fr = ref(img)
    got = lfnet.LFNetExtractor(num_features=N, device="cpu")
    assert not got.trained
    got.det.load_state_dict(interop.same_names_state_dict(flat_variables(ref.det_params)))
    got.desc.load_state_dict(interop.same_names_state_dict(flat_variables(ref.desc_params)))
    m = got.maps(torch.from_numpy(img))
    assert rel_err(m["score"], np.asarray(score)) <= TOL
    assert rel_err(m["scale"], np.asarray(scale)) <= TOL
    angle_g = torch.atan2(m["ori"][1], m["ori"][0])
    assert _wrapped(angle_g, np.asarray(angle), 2 * np.pi) <= TOL
    fg = got(img)
    assert fg.desc.shape == (N, 256)
    assert_same_features(fr, fg, TOL, min_valid=N)
    assert np.abs(np_(fg.size) - np.asarray(fr.size)).max() <= TOL
    assert _wrapped(fg.angle, np.asarray(fr.angle), 360.0) <= 1e-3
    # the checkpoint pair by path
    ckpt = str(tmp_path / "lfnet")
    save_variables_npz(ckpt + ".det.npz", ref.det_params)
    save_variables_npz(ckpt + ".desc.npz", ref.desc_params)
    loaded = lfnet.LFNetExtractor(num_features=N, checkpoint=ckpt, device="cpu")
    assert loaded.trained
    _same_state(loaded.det, got.det)
    _same_state(loaded.desc, got.desc)


def test_delf(img, tmp_path):
    with jax.enable_x64(False), compiled_flax_init():
        ref = jdelf.DELFExtractor(num_features=N)
    with jax.enable_x64(False):
        feat = jax.jit(ref.trunk.apply)(ref.trunk_params, jnp.asarray(img) / 255.0)
        attn, desc = jax.jit(ref.head.apply)(ref.head_params, feat)
        fr = ref(img)
    got = delf.DELFExtractor(num_features=N, device="cpu")
    got.trunk.load_state_dict(interop.same_names_state_dict(flat_variables(ref.trunk_params)))
    got.head.load_state_dict(interop.same_names_state_dict(flat_variables(ref.head_params)))
    m = got.maps(torch.from_numpy(img))
    assert rel_err(m["attn0"], np.asarray(attn)) <= TOL      # level 1: 96x128 as it is
    assert rel_err(m["desc0"], np.asarray(desc)) <= TOL
    fg = got(img)
    assert fg.desc.shape == (N, 40)
    # 6x8 + 4x5 candidates over both levels: 68 valid slots of 400
    assert_same_features(fr, fg, TOL, min_valid=68)
    assert np.array_equal(np_(fg.size), np.asarray(fr.size))
    ckpt = str(tmp_path / "delf")
    save_variables_npz(ckpt + ".trunk.npz", ref.trunk_params)
    save_variables_npz(ckpt + ".head.npz", ref.head_params)
    loaded = delf.DELFExtractor(num_features=N, checkpoint=ckpt, device="cpu")
    assert loaded.trained
    _same_state(loaded.trunk, got.trunk)
    _same_state(loaded.head, got.head)


def test_contextdesc_on_sift_keypoints(img, tmp_path):
    pytest.importorskip("cv2")
    from pyslam_tpu_torch.features.classical import CvSIFTExtractor

    fd = CvSIFTExtractor(num_features=200, device="cpu")(img)
    assert int(fd.valid.sum()) >= 10
    with jax.enable_x64(False), compiled_flax_init():
        ref = jctx.ContextDescExtractor()
    with jax.enable_x64(False):
        want = ref.compute(img, *[np_(x) for x in (fd.xy, fd.size, fd.angle)])
    got = contextdesc.ContextDescExtractor(device="cpu")
    assert not got.trained
    for part, net in zip(got.PARTS, got.nets()):
        net.load_state_dict(interop.same_names_state_dict(
            flat_variables(getattr(ref, f"{part}_params"))))
    d = np_(got.compute(torch.from_numpy(img), fd.xy, fd.size, fd.angle))
    assert d.shape == (200, 128) and np.isfinite(d).all()
    assert np.abs(d - want).max() <= TOL
    ckpt = str(tmp_path / "contextdesc")
    for part in got.PARTS:
        save_variables_npz(f"{ckpt}.{part}.npz", getattr(ref, f"{part}_params"))
    loaded = contextdesc.ContextDescExtractor(checkpoint=ckpt, device="cpu")
    assert loaded.trained
    for a, b in zip(loaded.nets(), got.nets()):
        _same_state(a, b)
