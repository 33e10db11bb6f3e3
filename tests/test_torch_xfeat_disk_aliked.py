"""XFeat, DISK and ALIKED in the port (pyslam_tpu_torch/models/{xfeat,
disk,aliked}.py) against the JAX package's extractors on a 96x128 image,
with the JAX package's ``PRNGKey(0)`` weights carried across
(``interop``); ALIKED's deformable gather at out-of-range offsets; and one
state dict in each official torch layout (the twins of tests/test_aliked.py
and tests/test_disk_r2d2.py, and XFeat's public layout), written to
``tmp_path`` and loaded into both packages.

Tolerances: the network's maps within 1e-4 of their largest magnitude;
keypoints identical (ALIKED's after its sub-pixel soft-argmax within 1e-4
px); responses and descriptors within 1e-4 absolute.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models import aliked as jaliked
from pyslam_tpu.models import disk as jdisk
from pyslam_tpu.models import xfeat as jxfeat
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import aliked, disk, xfeat
from tests.test_aliked import TAliked
from tests.test_aliked import _randomize_bn as randomize_aliked_bn
from tests.test_disk_r2d2 import TDiskUnet
from tests.torch_parity import (
    assert_same_features,
    compiled_flax_init,
    flat_variables,
    np_,
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


# the JAX extractors, built once; the official checkpoints go through
# their compiled ``_run``
@pytest.fixture(scope="module")
def ref_xfeat():
    with jax.enable_x64(False), compiled_flax_init():
        return jxfeat.XFeatExtractor(num_features=N)


@pytest.fixture(scope="module")
def ref_disk():
    with jax.enable_x64(False), compiled_flax_init():
        return jdisk.DiskExtractor(num_features=N)


@pytest.fixture(scope="module")
def ref_aliked():
    with jax.enable_x64(False), compiled_flax_init():
        return jaliked.AlikedExtractor(num_features=N)


def _rgb(img):
    return np.stack([img] * 3, -1)


def test_xfeat(img, ref_xfeat):
    ref = ref_xfeat
    with jax.enable_x64(False):
        maps = jax.jit(ref.net.apply)(ref.variables, jnp.asarray(img)[None, ..., None] / 255.0)
        fr = ref(img)
    got = xfeat.XFeatExtractor(num_features=N, device="cpu")
    assert not got.trained
    got.net.load_state_dict(interop.xfeat_state_dict(flat_variables(ref.variables)))
    m = got.maps(torch.from_numpy(img))
    for name, want in zip(("feats", "klogits", "heat"), maps):
        g = m[name] if name == "heat" else m[name].permute(1, 2, 0)
        assert rel_err(g, np.asarray(want)[0].squeeze(-1) if name == "heat"
                       else np.asarray(want)[0]) <= TOL, name
    fg = got(img)
    assert fg.desc.shape == (N, 64)
    assert_same_features(fr, fg, TOL, min_valid=100)


def test_disk(img, ref_disk):
    ref = ref_disk
    with jax.enable_x64(False):
        x = jnp.asarray(_rgb(img))[None] / 255.0
        desc, heat = jax.jit(ref.net.apply)(ref.params, x)
        fr = ref(img)
    got = disk.DiskExtractor(num_features=N, device="cpu")
    got.net.load_state_dict(interop.same_names_state_dict(flat_variables(ref.params)))
    m = got.maps(torch.from_numpy(_rgb(img)))
    assert m["heat"].shape == (48, 64)            # half resolution, as the reference
    assert rel_err(m["desc"].permute(1, 2, 0), np.asarray(desc)[0]) <= TOL
    assert rel_err(m["heat"], np.asarray(heat)[0]) <= TOL
    fg = got(img)
    assert fg.desc.shape == (N, 128)
    assert_same_features(fr, fg, TOL, min_valid=50)


def test_aliked(img, ref_aliked):
    ref = ref_aliked
    with jax.enable_x64(False):
        feats, score = jax.jit(ref.net.apply)(ref.net_params, jnp.asarray(_rgb(img)) / 255.0)
        fr = ref(img)
    got = aliked.AlikedExtractor(num_features=N, device="cpu")
    got.net.load_state_dict(interop.aliked_state_dict(flat_variables(ref.net_params),
                                                      flat_variables(ref.head_params)))
    m = got.maps(torch.from_numpy(_rgb(img)))
    assert rel_err(m["feats"], np.asarray(feats)) <= TOL
    assert rel_err(m["score"], np.asarray(score)) <= TOL
    fg = got(img)
    assert fg.desc.shape == (N, 128)
    assert_same_features(fr, fg, TOL, xy_tol=1e-4, min_valid=100)


def test_aliked_gather_out_of_range():
    """The reference's boundary rule (indices clamped, weights of the
    unclamped floor) at coordinates far outside the map, and a deformable
    conv whose offsets push every tap out (offset bias +-9 px)."""
    r = rng(7)
    fmap = r.normal(0, 1, (6, 7, 4)).astype(np.float32)
    ys = r.uniform(-5, 11, (5, 9)).astype(np.float32)
    xs = r.uniform(-6, 13, (5, 9)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jaliked.bilinear_sample(jnp.asarray(fmap), jnp.asarray(ys),
                                                  jnp.asarray(xs)))
    got = aliked.bilinear_sample(torch.from_numpy(fmap), torch.from_numpy(ys),
                                 torch.from_numpy(xs))
    assert np.abs(np_(got) - want).max() <= 1e-6
    with jax.enable_x64(False):
        conv = jaliked.DeformConv(8)
        params = conv.init(jax.random.PRNGKey(1), jnp.asarray(fmap))
        p = jax.tree_util.tree_map(np.array, params)
        p["params"]["offset_conv"]["bias"] = r.choice([-9.0, 9.0], 18).astype(np.float32)
        want = np.asarray(conv.apply(p, jnp.asarray(fmap)))
    dc = aliked.DeformConv(4, 8)
    flat = flat_variables(p)
    dc.load_state_dict({
        "offset_conv.weight": torch.from_numpy(
            flat["params/offset_conv/kernel"].transpose(3, 2, 0, 1).copy()),
        "offset_conv.bias": torch.from_numpy(flat["params/offset_conv/bias"]),
        "conv.weight": interop._dense_to_conv(flat["params/conv/kernel"], 3),
        "conv.bias": torch.from_numpy(flat["params/conv/bias"])})
    with torch.no_grad():
        y = dc(torch.from_numpy(fmap).permute(2, 0, 1)[None])[0].permute(1, 2, 0)
    assert np.abs(np_(y) - want).max() <= TOL


def _compare(run_out, got, img, xy_tol=0.0):
    """The JAX ``_run`` outputs (xy, response, valid, desc) against the
    port's extractor loaded from the same checkpoint."""
    xy, resp, valid, desc = run_out
    assert got.trained
    fr = SimpleNamespace(xy=xy, response=resp, valid=valid, desc=desc)
    assert_same_features(fr, got(img), TOL, xy_tol=xy_tol, min_valid=20)


def test_official_xfeat_checkpoint(img, ref_xfeat, tmp_path):
    """The public XFeatModel layout (with its ``fine_matcher`` and the batch
    counters, which both packages ignore)."""
    from pyslam_tpu.models.torch_convert import xfeat_from_torch_file

    net = interop.seeded_init_(xfeat.XFeatNet(), 11)
    r = rng(8)
    sd = {}
    for k, v in net.state_dict().items():
        if k.endswith("running_mean"):
            v = torch.from_numpy(r.normal(0, 0.2, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            v = torch.from_numpy(r.uniform(0.5, 2.0, v.shape).astype(np.float32))
        sd[k] = v
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    sd["fine_matcher.0.weight"] = torch.zeros(512, 128)
    path = str(tmp_path / "xfeat.pt")
    torch.save(sd, path)
    with jax.enable_x64(False):
        out = ref_xfeat._run(xfeat_from_torch_file(path, ref_xfeat.variables),
                             jnp.asarray(img), N)
    _compare(out, xfeat.XFeatExtractor(N, checkpoint=path, device="cpu"), img)


def test_official_disk_checkpoint(img, ref_disk, tmp_path):
    torch.manual_seed(12)
    twin = TDiskUnet()
    path = str(tmp_path / "depth-save.pth")
    torch.save({"extractor": twin.state_dict()}, path)
    with jax.enable_x64(False):
        out = ref_disk._run(jdisk.disk_from_torch(twin.state_dict(), None),
                            jnp.asarray(_rgb(img)), N)
    _compare(out, disk.DiskExtractor(N, checkpoint=path, device="cpu"), img)


def test_official_aliked_checkpoint(img, ref_aliked, tmp_path):
    torch.manual_seed(13)
    twin = TAliked().eval()
    with torch.no_grad():
        randomize_aliked_bn(twin, rng(9))
    path = str(tmp_path / "aliked-n16.pth")
    torch.save(twin.state_dict(), path)
    with jax.enable_x64(False):
        out = ref_aliked._run(*jaliked.aliked_from_torch(twin.state_dict(), None),
                              jnp.asarray(_rgb(img)), N)
    _compare(out, aliked.AlikedExtractor(N, checkpoint=path, device="cpu"), img,
             xy_tol=1e-4)
