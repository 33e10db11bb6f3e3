"""The patch-descriptor networks of the port
(pyslam_tpu_torch/models/patch_descriptors.py) against the JAX package's,
with its ``PRNGKey(0)`` weights carried across (``interop``): HardNet,
SOSNet, L2Net, TFeat, GeoDesc and the log-polar net on 16 seeded 32x32
patches, ``PatchDescriptorExtractor.compute`` on the ORB2 keypoints of a
120x160 image, and a state dict in each official torch layout (the torch
twins of tests/test_patch_descriptors.py, random weights and batch-norm
statistics) written to ``tmp_path`` and loaded into both packages.

Tolerance: descriptors within 1e-5 absolute (float32 convolutions summed
in another order; the patches' bilinear taps are the reference's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models import patch_descriptors as jpd
from pyslam_tpu.models.torch_convert import save_variables_npz
from pyslam_tpu_torch.features.orb2 import ORB2Extractor
from pyslam_tpu_torch.models import patch_descriptors as tpd
from tests.test_patch_descriptors import (
    _randomize_bn,
    _TorchHardNet,
    _TorchL2Net,
    _TorchSOSNet,
    _TorchTFeat,
)
from tests.torch_parity import flat_variables, np_, rng, synth_image

TOL = 1e-5
KINDS = ("HARDNET", "SOSNET", "L2NET", "TFEAT", "GEODESC", "LOGPOLAR")


def _pair(kind):
    """The JAX extractor and the port's on the CPU with its weights."""
    with jax.enable_x64(False):
        ref = jpd.PatchDescriptorExtractor(kind)
    got = tpd.PatchDescriptorExtractor(kind, device="cpu")
    assert not got.trained
    got.net.load_state_dict(got._from_jax(flat_variables(ref.variables)))
    return ref, got


@pytest.mark.parametrize("kind", KINDS)
def test_net(kind):
    ref, got = _pair(kind)
    patches = rng(1).uniform(0, 255, (16, 32, 32)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(ref.model.apply)(ref.variables, jnp.asarray(patches)))
    with torch.no_grad():
        d = np_(got.net(torch.from_numpy(patches)))
    assert d.shape == want.shape == (16, 128)
    assert np.abs(d - want).max() <= TOL


@pytest.mark.parametrize("kind", ("HARDNET", "TFEAT", "LOGPOLAR"))
def test_compute_on_orb2_keypoints(kind):
    """Cartesian patches at magnification 1 and 3 and log-polar patches
    around every ORB2 slot of a 120x160 image (oriented, scaled by level)."""
    ref, got = _pair(kind)
    img = np.round(synth_image(rng(2), 120, 160))
    fd = ORB2Extractor(300, 4, device="cpu")(img)
    args = [np_(x) for x in (fd.xy, fd.size, fd.angle)]
    with jax.enable_x64(False):
        want = ref.compute(img, *args)
    d = np_(got.compute(torch.from_numpy(img), fd.xy, fd.size, fd.angle))
    valid = np_(fd.valid)
    assert d.shape == (300, 128) and valid.sum() > 50
    assert np.abs(d - want).max() <= TOL
    assert got.compute(torch.from_numpy(img), *[torch.zeros(0)] * 3).shape == (0, 128)


# torch twin, the name of its Sequential in the official checkpoint
OFFICIAL = {"HARDNET": (_TorchHardNet, "features"), "SOSNET": (_TorchSOSNet, "layers"),
            "L2NET": (_TorchL2Net, "features"), "TFEAT": (_TorchTFeat, "features"),
            "LOGPOLAR": (_TorchHardNet, "features")}


@pytest.mark.parametrize("kind", sorted(OFFICIAL))
def test_official_checkpoint_loads_in_both(kind, tmp_path):
    twin_cls, prefix = OFFICIAL[kind]
    torch.manual_seed(3)
    twin = twin_cls().eval()
    with torch.no_grad():
        _randomize_bn(twin, rng(4))
    sd = {k.replace("features.", f"{prefix}."): v for k, v in twin.state_dict().items()}
    path = str(tmp_path / f"{kind.lower()}.pth")
    torch.save(sd, path)
    patches = rng(5).uniform(0, 255, (8, 32, 32)).astype(np.float32)
    with jax.enable_x64(False):
        ref = jpd.PatchDescriptorExtractor(kind)
        ref.load_torch(path)
        want = np.asarray(jax.jit(ref.model.apply)(ref.variables, jnp.asarray(patches)))
    got = tpd.PatchDescriptorExtractor(kind, checkpoint=path, device="cpu")
    assert got.trained
    with torch.no_grad():
        d = np_(got.net(torch.from_numpy(patches)))
        if kind != "LOGPOLAR":     # the twin's own forward (the log-polar net is HardNet's)
            assert np.abs(np_(twin(torch.from_numpy(patches)[:, None])) - d).max() <= 1e-4
    assert np.abs(d - want).max() <= TOL


def test_geodesc_npz_and_inter(tmp_path):
    """GeoDesc comes from TF1: its weights arrive as the JAX package's
    ``.npz``; the conv5 map (``return_inter``) that ContextDesc reads
    agrees too, and a torch file is refused."""
    with jax.enable_x64(False):
        ref = jpd.PatchDescriptorExtractor("GEODESC")
    path = str(tmp_path / "geodesc.npz")
    save_variables_npz(path, ref.variables)
    got = tpd.PatchDescriptorExtractor("GEODESC", checkpoint=path, device="cpu")
    assert got.trained
    patches = rng(6).uniform(0, 255, (4, 32, 32)).astype(np.float32)
    with jax.enable_x64(False):
        d, inter = jax.jit(ref.model.apply, static_argnames="return_inter")(
            ref.variables, jnp.asarray(patches), return_inter=True)
    with torch.no_grad():
        dg, ig = got.net(torch.from_numpy(patches), return_inter=True)
    assert np.abs(np_(dg) - np.asarray(d)).max() <= TOL
    assert np.abs(np_(ig).transpose(0, 2, 3, 1) - np.asarray(inter)).max() <= 1e-4
    with pytest.raises(NotImplementedError, match="TF1"):
        got.load_checkpoint(str(tmp_path / "geodesc.pth"))
