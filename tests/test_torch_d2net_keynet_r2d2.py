"""D2-Net (64x96), Key.Net with HardNet and R2D2 (96x128) in the port
(pyslam_tpu_torch/models/{d2net,keynet,r2d2}.py) against the JAX package's
extractors, with its ``PRNGKey(0)`` weights carried across (``interop``);
and one state dict in each official torch layout (the D2-Net and R2D2 twins
of tests/test_d2net_keynet.py and tests/test_disk_r2d2.py, a kornia-style
Key.Net), written to ``tmp_path`` and loaded into both packages.

Tolerances: the network's maps within 1e-4 of their largest magnitude;
keypoints identical (R2D2 from the twin's flat default init: 95 % of the
slots, the rest near-ties); responses and descriptors within 1e-4
absolute.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from pyslam_tpu.models import d2net as jd2net
from pyslam_tpu.models import keynet as jkeynet
from pyslam_tpu.models import r2d2 as jr2d2
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import d2net, keynet, r2d2
from tests.test_d2net_keynet import TD2Net
from tests.test_disk_r2d2 import TQuadL2NetConfCFS
from tests.test_disk_r2d2 import _randomize_bn as randomize_r2d2_bn
from tests.torch_parity import (
    assert_same_features,
    compiled_flax_init,
    flat_variables,
    rel_err,
    rng,
)

TOL = 1e-4
N = 400


@pytest.fixture(scope="module")
def img():
    im = rng(0).uniform(0, 255, (96, 128)).astype(np.float32)
    im[30:60, 40:80] += 80
    return np.clip(im, 0, 255)


def _rgb(img):
    return np.stack([img] * 3, -1)


def _compare(run_out, got, img, min_same=1.0):
    xy, resp, valid, desc = run_out
    assert got.trained
    fr = SimpleNamespace(xy=xy, response=resp, valid=valid, desc=desc)
    assert_same_features(fr, got(img), TOL, min_valid=20, min_same=min_same)


@pytest.fixture(scope="module")
def ref_d2net():
    with jax.enable_x64(False), compiled_flax_init():
        return jd2net.D2NetExtractor(num_features=N)


def _caffe(img):
    return jnp.asarray((_rgb(img)[..., ::-1] - jd2net.D2NetExtractor._MEAN).copy())


def test_d2net(img, ref_d2net):
    ref, im = ref_d2net, img[:64, :96]
    with jax.enable_x64(False):
        feats = jax.jit(ref.net.apply)(ref.params, _caffe(im)[None])[0]
        score = jd2net.d2net_soft_scores(feats)
        fr = ref(im)
    got = d2net.D2NetExtractor(num_features=N, device="cpu")
    assert not got.trained
    got.net.load_state_dict(interop.same_names_state_dict(flat_variables(ref.params)))
    f = got.maps(torch.from_numpy(_rgb(im)))["feats"]
    assert f.shape == (512, 16, 24)
    assert rel_err(f.permute(1, 2, 0), np.asarray(feats)) <= TOL
    assert rel_err(d2net.d2net_soft_scores(f), np.asarray(score)) <= TOL
    fg = got(im)
    assert fg.desc.shape == (N, 512) and float(fg.size[0]) == 16.0
    assert_same_features(fr, fg, TOL, min_valid=20)


def test_official_d2net_checkpoint(img, ref_d2net, tmp_path):
    torch.manual_seed(21)
    twin = TD2Net().eval()
    sd = {f"dense_feature_extraction.{k}": v for k, v in twin.state_dict().items()}
    path = str(tmp_path / "d2_tf.pth")
    torch.save({"model": sd}, path)
    im = img[:64, :96]
    with jax.enable_x64(False):
        out = ref_d2net._run(jd2net.d2net_from_torch(sd), _caffe(im), N)
    _compare(out, d2net.D2NetExtractor(N, checkpoint=path, device="cpu"), im)


@pytest.fixture(scope="module")
def ref_keynet():
    with jax.enable_x64(False), compiled_flax_init():
        return jkeynet.KeyNetExtractor(num_features=N)


def _carry_keynet(ref, got):
    got.descriptor.net.load_state_dict(
        interop.hardnet_state_dict(flat_variables(ref.descriptor.variables)))


def test_keynet_hardnet(img, ref_keynet):
    ref = ref_keynet
    with jax.enable_x64(False):
        score = jax.jit(ref.net.apply)(ref.params, jnp.asarray(img / 255.0))
        fr = ref(img)
    got = keynet.KeyNetExtractor(num_features=N, device="cpu")
    got.net.load_state_dict(interop.same_names_state_dict(flat_variables(ref.params)))
    _carry_keynet(ref, got)
    assert rel_err(got.maps(torch.from_numpy(img))["score"], np.asarray(score)) <= TOL
    fg = got(img)
    assert fg.desc.shape == (N, 128)
    assert (fg.size.numpy() == 31.0).all() and (fg.angle.numpy() == -1.0).all()
    assert_same_features(fr, fg, TOL, min_valid=100)


class TKeyNet(tnn.Module):
    """kornia-style Key.Net learnable block: 3 conv + BN + ReLU, 1x1 last."""

    def __init__(self):
        super().__init__()
        blocks, cin = [], 10
        for _ in range(3):
            blocks += [tnn.Conv2d(cin, 8, 3, padding=1, bias=False), tnn.BatchNorm2d(8),
                       tnn.ReLU()]
            cin = 8
        self.feature_extractor = tnn.Sequential(*blocks)
        self.last_conv = tnn.Conv2d(24, 1, 1)


def test_official_keynet_checkpoint(img, ref_keynet, tmp_path):
    torch.manual_seed(22)
    twin = TKeyNet().eval()
    with torch.no_grad():
        randomize_r2d2_bn(twin, rng(10))
        twin.last_conv.bias.fill_(0.05)
    path = str(tmp_path / "keynet.pth")
    torch.save(twin.state_dict(), path)
    with jax.enable_x64(False):
        xy, resp, valid = ref_keynet._detect(jkeynet.keynet_from_torch(twin.state_dict()),
                                             jnp.asarray(img / 255.0), N)
        n = N
        desc = ref_keynet.descriptor.compute(img, np.asarray(xy), np.full(n, 31.0, np.float32),
                                             np.full(n, -1.0, np.float32))
    got = keynet.KeyNetExtractor(N, checkpoint=path, device="cpu")
    _carry_keynet(ref_keynet, got)
    _compare((xy, resp, valid, desc), got, img)


@pytest.fixture(scope="module")
def ref_r2d2():
    with jax.enable_x64(False), compiled_flax_init():
        return jr2d2.R2D2Extractor(num_features=N)


def _imagenet(img):
    return jnp.asarray((_rgb(img) / 255.0 - jr2d2._IMAGENET_MEAN) / jr2d2._IMAGENET_STD)


def test_r2d2(img, ref_r2d2):
    ref = ref_r2d2
    with jax.enable_x64(False):
        desc, rel, rep = jax.jit(ref.net.apply)(ref.params, _imagenet(img)[None])
        fr = ref(img)
    got = r2d2.R2D2Extractor(num_features=N, device="cpu")
    got.net.load_state_dict(interop.r2d2_state_dict(flat_variables(ref.params)))
    m = got.maps(torch.from_numpy(_rgb(img)))
    assert rel_err(m["desc"].permute(1, 2, 0), np.asarray(desc)[0]) <= TOL
    assert rel_err(m["rel"], np.asarray(rel)[0]) <= TOL
    assert rel_err(m["rep"], np.asarray(rep)[0]) <= TOL
    fg = got(img)
    assert fg.desc.shape == (N, 128)
    assert_same_features(fr, fg, TOL, min_valid=100)


def test_official_r2d2_checkpoint(img, ref_r2d2, tmp_path):
    """The twin's default init makes a flat score map (all of it within
    0.2076-0.2178): 13 of the 400 slots sit at near-ties that the two
    packages' float32 sums order apart (responses 2e-8 apart), so 95 % of
    the slots must agree and the others' responses within 1e-4."""
    torch.manual_seed(23)
    twin = TQuadL2NetConfCFS().eval()
    with torch.no_grad():
        randomize_r2d2_bn(twin, rng(11))
    path = str(tmp_path / "r2d2_WASF_N16.pt")
    torch.save({"state_dict": twin.state_dict()}, path)
    with jax.enable_x64(False):
        out = ref_r2d2._run(jr2d2.r2d2_from_torch(twin.state_dict(), None), _imagenet(img), N)
    _compare(out, r2d2.R2D2Extractor(N, checkpoint=path, device="cpu"), img, min_same=0.95)
