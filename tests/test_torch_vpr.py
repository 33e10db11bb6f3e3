"""The learned VPR detectors in the port against the JAX package, with its
``PRNGKey(0)`` weights carried across (``interop.netvlad_state_dict``,
``megaloc_state_dict``, ``alexnet_state_dict``, DELF's
``same_names_state_dict``), the JAX package run with x64 off: NetVLAD
(VGG16 conv5 and 64 clusters, on a 96x128 input), MegaLoc at the
configuration of tests/test_vpr_backends.py, AlexNet conv3 at 128 px and
HDC-DELF (1024-d, 128 DELF keypoints; its codebooks from the same seed).

Tolerances: each global descriptor within 1e-5 of its largest magnitude
(unit vectors).  Sinkhorn: a transport plan (non-negative, unit rows
within 1e-5) equal to the JAX package's within 1e-5.  ``LoopDetector``
builds on the CPU for every ``GlobalDescriptorType`` and describes a frame
by a finite unit descriptor; the official NetVLAD and AlexNet layouts load
by name.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.loop_closing import vpr as jvpr
from pyslam_tpu.models import megaloc as jmegaloc
from pyslam_tpu.models import netvlad as jnetvlad
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.loop_closing import vpr
from pyslam_tpu_torch.models import megaloc, netvlad
from tests.torch_parity import compiled_flax_init, flat_variables, rel_err, rng
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-5
MEGALOC_CFG = dict(img_px=56, patch=14, dim=64, depth=2, heads=4, clusters=8, cluster_dim=16,
                   token_dim=32)


def _img(seed, shift=0):
    r = rng(seed)
    im = r.uniform(0, 200, (120, 160)).astype(np.float32)
    im[40 + shift:80 + shift, 50:110] += 55
    return np.clip(im, 0, 255)


def test_netvlad(tmp_path):
    with jax.enable_x64(False), compiled_flax_init():
        ref = jnetvlad.NetVLADExtractor(input_hw=(96, 128))
    got = netvlad.NetVLADExtractor(input_hw=(96, 128), device="cpu")
    assert not got.trained
    got.net.load_state_dict(interop.netvlad_state_dict(flat_variables(ref.params)))
    for seed in (1, 2):
        with jax.enable_x64(False):
            want = ref(_img(seed))
        g = got(_img(seed))
        assert g.shape == (64 * 512,) and rel_err(g, want) <= TOL
    # the pytorch-NetVlad names: the port's weights as such a checkpoint
    path = str(tmp_path / "netvlad.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in got.net.state_dict().items()}},
               path)
    with jax.enable_x64(False):
        from pyslam_tpu.models.torch_convert import netvlad_from_torch_file

        ref.params = netvlad_from_torch_file(path, ref.params)
        want = ref(_img(3))
    loaded = netvlad.NetVLADExtractor(input_hw=(96, 128), device="cpu")
    from pyslam_tpu_torch.models.torch_convert import netvlad_from_torch_file as port_file

    loaded.net.load_state_dict(port_file(path))
    assert rel_err(loaded(_img(3)), want) <= TOL


def test_megaloc():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jmegaloc.MegaLocExtractor(jmegaloc.MegaLocConfig(**MEGALOC_CFG))
    got = megaloc.MegaLocExtractor(megaloc.MegaLocConfig(**MEGALOC_CFG), device="cpu")
    got.net.load_state_dict(interop.megaloc_state_dict(flat_variables(ref.params)))
    assert got.dim == ref.dim == 32 + 8 * 16
    for seed in (1, 2):
        with jax.enable_x64(False):
            want = ref(_img(seed))
        assert rel_err(got(_img(seed)), want) <= TOL


def test_sinkhorn_is_a_transport_plan():
    scores = rng(0).normal(0, 1, (32, 9)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jmegaloc.sinkhorn(jnp.asarray(scores), 5))
    plan = megaloc.sinkhorn(torch.from_numpy(scores), 5).numpy()
    assert (plan >= 0).all()
    assert np.abs(plan.sum(axis=1) - 1.0).max() <= TOL           # rows = tokens
    assert np.abs(plan - want).max() <= TOL


def test_alexnet(tmp_path):
    with jax.enable_x64(False), compiled_flax_init():
        ref = jvpr.AlexNetExtractor(img_px=128)
    got = vpr.AlexNetExtractor(img_px=128, device="cpu")
    got.net.load_state_dict(interop.alexnet_state_dict(flat_variables(ref.params)))
    for seed in (1, 3):
        with jax.enable_x64(False):
            want = ref(_img(seed))
        assert rel_err(got(_img(seed)), want) <= TOL
    # a torchvision AlexNet state dict (the classifier is not read)
    sd = dict(got.net.state_dict())
    sd.update({"features.8.weight": torch.zeros(256, 384, 3, 3),
               "classifier.1.weight": torch.zeros(4096, 9216)})
    path = str(tmp_path / "alexnet.pth")
    torch.save(sd, path)
    loaded = vpr.AlexNetExtractor(img_px=128, checkpoint=path, device="cpu")
    assert loaded.trained
    with jax.enable_x64(False), compiled_flax_init():
        ref2 = jvpr.AlexNetExtractor(img_px=128, checkpoint=path)
    with jax.enable_x64(False):
        want = ref2(_img(4))
    assert rel_err(loaded(_img(4)), want) <= TOL


def test_hdc_delf():
    from pyslam_tpu.models import delf as jdelf
    from pyslam_tpu_torch.models import delf

    with jax.enable_x64(False), compiled_flax_init():
        jd = jdelf.DELFExtractor(num_features=128)
        ref = jvpr.HDCDelfExtractor(hdc_dim=1024, num_features=128, delf=jd)
    d = delf.DELFExtractor(num_features=128, device="cpu")
    d.trunk.load_state_dict(interop.same_names_state_dict(flat_variables(jd.trunk_params)))
    d.head.load_state_dict(interop.same_names_state_dict(flat_variables(jd.head_params)))
    got = vpr.HDCDelfExtractor(hdc_dim=1024, num_features=128, delf=d, device="cpu")
    np.testing.assert_array_equal(got.proj.numpy(), np.asarray(ref.proj))
    np.testing.assert_array_equal(got.phase_x.numpy(), np.asarray(ref.phase_x))
    np.testing.assert_array_equal(got.phase_y.numpy(), np.asarray(ref.phase_y))
    for seed in (1, 4):
        with jax.enable_x64(False):
            want = ref(_img(seed))
        g = got(_img(seed))
        assert g.shape == (1024,) and rel_err(g, want) <= TOL


@pytest.mark.parametrize("gdt", ["DBOW2", "DBOW3", "IBOW", "OBINDEX2", "VLAD", "NETVLAD",
                                 "HDC_DELF", "SAD", "ALEXNET", "COSPLACE", "EIGENPLACES",
                                 "MEGALOC"])
def test_loop_detector_builds_for_every_type(gdt):
    """A ``LoopDetector`` for each ``GlobalDescriptorType`` on the CPU:
    score-based exactly for the global-descriptor types, which describe a
    frame (its 64x160 thumbnail and 120x160 half-resolution image) by a finite
    unit vector; the image detectors set ``kRetainImageForVPR``."""
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
    from pyslam_tpu_torch.loop_closing.loop_detector_configs import (
        GlobalDescriptorType,
        LoopDetectorConfig,
    )

    g = GlobalDescriptorType[gdt]
    assert g.name == gdt
    cfg = LoopDetectorConfig(name=gdt, global_descriptor_type=g,
                             num_words=64 if gdt == "VLAD" else 4096)
    saved = Parameters.kRetainImageForVPR
    try:
        Parameters.kRetainImageForVPR = False
        det = LoopDetector(cfg, device="cpu")
        images = gdt in ("NETVLAD", "HDC_DELF", "ALEXNET", "COSPLACE", "EIGENPLACES", "MEGALOC")
        assert Parameters.kRetainImageForVPR == images
    finally:
        Parameters.kRetainImageForVPR = saved
    assert det.score_based == (gdt not in ("DBOW2", "DBOW3", "IBOW", "OBINDEX2"))
    if not det.score_based:
        return
    r = rng(0)
    des = torch.from_numpy(r.integers(0, 2, (200, 256)).astype(np.int8))
    valid = torch.ones(200, dtype=torch.bool)
    img = _img(5).astype(np.uint8)
    frame = SimpleNamespace(img_vpr=img, img_thumb=img[:64].astype(np.float32),
                            des=des.numpy(), valid=valid.numpy(),
                            dev=lambda name: {"des": des, "valid": valid}[name])
    words, v = det.describe_frame(frame)
    assert words is None and np.isfinite(v).all()
    assert abs(np.linalg.norm(v) - 1.0) < 1e-4
    if gdt != "VLAD":
        return
    # the VLAD placeholder (untrained), then the trained descriptor
    assert v.shape == (64 * 256,)
    for _ in range(det.vlad.train_after):
        det.describe_frame(frame)
    assert det.vlad.trained and det.vlad.consume_just_trained()
    assert not det.vlad.consume_just_trained()


def test_image_detectors_fall_back_to_the_mean_descriptor():
    from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
    from pyslam_tpu_torch.loop_closing.loop_detector_configs import LoopDetectorConfigs

    det = LoopDetector(dataclasses.replace(LoopDetectorConfigs.SAD), device="cpu")
    des = rng(1).normal(0, 1, (50, 32)).astype(np.float32)
    valid = np.ones(50, bool)
    frame = SimpleNamespace(img_vpr=None, img_thumb=None, des=des, valid=valid)
    _, v = det.describe_frame(frame)
    m = des.mean(0)
    np.testing.assert_allclose(v, m / np.linalg.norm(m), rtol=1e-6)
