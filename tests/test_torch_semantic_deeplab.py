"""DeepLabV3 of the port (pyslam_tpu_torch/models/deeplabv3.py) against the
JAX package's over ResNet-18 on a 64x80 canvas, with its ``PRNGKey(0)``
weights carried across, and a torchvision-layout checkpoint read by both
packages (split from tests/test_torch_semantic_models.py, whose docstring
states the tolerances and whose helpers these tests use, so that the xdist
workers share the semantic models' time)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models import deeplabv3 as jdl
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import deeplabv3
from tests.test_torch_semantic_models import TOL, _image, assert_labels_but_near_ties
from tests.torch_parity import compiled_flax_init, flat_variables, np_, rel_err, rng
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)


@pytest.fixture(scope="module")
def deeplab():
    """The JAX package's segmenter over ResNet-18 (its class fixes
    ResNet-50), and the port's with its weights."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False), compiled_flax_init():
        mp.setattr(jdl, "DeepLabV3", functools.partial(jdl.DeepLabV3, arch="resnet18"))
        ref = jdl.DeepLabV3Segmenter(num_classes=6)
    got = deeplabv3.DeepLabV3Segmenter(num_classes=6, device="cpu")
    assert not got.trained and got.net.backbone.arch == "resnet50"
    got.net = deeplabv3.DeepLabV3(num_classes=6, arch="resnet18")
    got.net.load_state_dict(interop.deeplabv3_state_dict(flat_variables(ref.variables)))
    got.net.eval()
    return ref, got


def test_deeplabv3_logits(deeplab):
    ref, got = deeplab
    x = got.prepare(_image(1, 60, 75))
    assert x.shape == (64, 80, 3)
    with jax.enable_x64(False):
        want = np.asarray(ref.net.apply(ref.variables, jnp.asarray(x[None])))[0]
    out = np_(got.logits(x)).transpose(1, 2, 0)
    assert out.shape == (64, 80, 6) and rel_err(out, want) <= TOL


def test_deeplabv3_infer(deeplab):
    ref, got = deeplab
    img = _image(2, 60, 75)
    with jax.enable_x64(False):
        want = ref.infer(img)
    out = got.infer(img)
    assert out["labels"].dtype == np.int32 and out["labels"].shape == (60, 75)
    assert rel_err(out["probs"], want["probs"]) <= TOL
    logits = np_(got.logits(got.prepare(img)))[:, :60, :75]
    assert_labels_but_near_ties(out["labels"], want["labels"], logits, axis=0)


def test_deeplabv3_from_torch():
    """A torchvision-layout checkpoint (``aux_classifier`` and the batch
    counters included) loads into both packages: the same logits."""
    from pyslam_tpu.models.deeplabv3 import deeplabv3_from_torch as jconvert
    from pyslam_tpu_torch.models.torch_convert import _DEEPLAB_HEAD, deeplabv3_from_torch

    net = deeplabv3.DeepLabV3(num_classes=5, arch="resnet18")
    interop.seeded_init_(net, 3)
    to_tv = {v: k for k, v in _DEEPLAB_HEAD.items()}
    sd = {}
    for k, v in net.state_dict().items():
        mod, leaf = k.rsplit(".", 1)
        sd[k if k.startswith("backbone.") else f"{to_tv[mod]}.{leaf}"] = v.clone()
    sd["backbone.bn1.num_batches_tracked"] = torch.tensor(7)
    sd["aux_classifier.0.weight"] = torch.zeros(3)
    got = deeplabv3.DeepLabV3(num_classes=5, arch="resnet18")
    got.load_state_dict(deeplabv3_from_torch(sd))
    x = rng(4).normal(size=(48, 64, 3)).astype(np.float32)
    jnet = jdl.DeepLabV3(num_classes=5, arch="resnet18")
    with jax.enable_x64(False):
        want = np.asarray(jnet.apply(jconvert(sd, 5), jnp.asarray(x[None])))[0]
    with torch.no_grad():
        out = got(torch.from_numpy(x).permute(2, 0, 1)[None])[0].numpy().transpose(1, 2, 0)
    assert rel_err(out, want) <= TOL
