"""VGGT and Fast3R in the port (pyslam_tpu_torch/models/{vggt,fast3r}.py) and
the VGGT, VGGT_ROBUST and FAST3R backends of scene_from_views against the
JAX package's, with its ``PRNGKey(0)`` weights carried across
(``interop.vggt_state_dict`` / ``fast3r_state_dict``), the JAX package run
with x64 off: the ``TINY_VGGT`` and ``TINY_F3R`` configurations of
tests/test_vggt_fast3r.py.

Tolerance: every output (points, confidences, poses, fov, anchor mass,
local points and confidences, the backends' clouds) within ``TOL`` = 1e-4
of its largest magnitude; the kept views and the cloud sizes identical.
"""

import jax
import numpy as np
import pytest

from pyslam_tpu.models import fast3r as jfast3r
from pyslam_tpu.models import vggt as jvggt
from pyslam_tpu.scene_from_views import scene_from_views as jsfv
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import fast3r, vggt
from pyslam_tpu_torch.scene_from_views import scene_from_views as tsfv
from tests.torch_parity import compiled_flax_init, flat_variables, rel_err, rng
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-4
TINY_VGGT = dict(img_hw=(32, 32), patch=16, dim=32, depth_pairs=2, heads=2)
TINY_F3R = dict(img_hw=(32, 32), patch=16, enc_dim=32, enc_depth=2, enc_heads=2, dec_dim=32,
                dec_depth=2, dec_heads=2, max_views=8)


@pytest.fixture(scope="module")
def vg():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jvggt.VGGTModel(jvggt.VGGTConfig(**TINY_VGGT))
    got = vggt.VGGTModel(vggt.VGGTConfig(**TINY_VGGT), device="cpu")
    assert not got.trained
    got.net.load_state_dict(interop.vggt_state_dict(flat_variables(ref.params)))
    return ref, got


@pytest.fixture(scope="module")
def f3r():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jfast3r.Fast3RModel(jfast3r.Fast3RConfig(**TINY_F3R))
    got = fast3r.Fast3RModel(fast3r.Fast3RConfig(**TINY_F3R), device="cpu")
    assert not got.trained
    got.net.load_state_dict(interop.fast3r_state_dict(flat_variables(ref.params)))
    return ref, got


def _imgs(seed, v, hw=(40, 48)):
    r = rng(seed)
    return [r.uniform(0, 255, hw).astype(np.float32) for _ in range(v)]


def _same_outputs(want: dict, got: dict):
    assert set(want) <= set(got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k], want[k]) <= TOL, (k, rel_err(got[k], want[k]))


def test_vggt_infer_views(vg):
    ref, got = vg
    imgs = _imgs(0, 3)                        # 40x48: resampled to 32x32 by index truncation
    with jax.enable_x64(False):
        want = ref.infer_views(imgs)
    out = got.infer_views(imgs)
    _same_outputs(want, out)
    assert out["poses"].dtype == np.float64


def test_vggt_gauge(vg):
    _, got = vg
    out = got.infer_views(_imgs(1, 4))
    assert np.allclose(out["poses"][0], np.eye(4), atol=1e-6)
    for R in out["poses"][:, :3, :3]:
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-4)
    # the quaternion rotation of the reference's host code
    q = np.random.default_rng(2).normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    assert np.allclose(vggt._quat_to_R(q), jvggt._quat_to_R(q), atol=0)


def test_fast3r_infer_views(f3r):
    ref, got = f3r
    imgs = _imgs(3, 4)
    with jax.enable_x64(False):
        want = ref.infer_views(imgs)
    _same_outputs(want, got.infer_views(imgs))


def test_fast3r_refuses_more_views_than_its_pool(f3r):
    _, got = f3r
    with pytest.raises(ValueError, match="index embedding"):
        got.infer_views(_imgs(4, TINY_F3R["max_views"] + 1, hw=(32, 32)))


def _lowered_mass(model, view):
    """The model with view ``view``'s anchor mass cut to a tenth, so that
    the robust test drops it."""

    class Low:
        def infer_views(self, images):
            out = model.infer_views(images)
            out["anchor_mass"] = out["anchor_mass"].copy()
            out["anchor_mass"][view] *= 0.1
            return out

    return Low()


@pytest.mark.parametrize("stype,low", [("vggt", None), ("vggt_robust", None),
                                       ("vggt_robust", 2), ("fast3r", None)])
def test_backends(vg, f3r, monkeypatch, stype, low):
    (jv, tv), (jf, tf) = vg, f3r
    if low is not None:
        jv, tv = _lowered_mass(jv, low), _lowered_mass(tv, low)
    monkeypatch.setattr(jvggt, "VGGTModel", lambda checkpoint=None: jv)
    monkeypatch.setattr(vggt, "VGGTModel", lambda checkpoint=None, device=None: tv)
    monkeypatch.setattr(jfast3r, "Fast3RModel", lambda checkpoint=None: jf)
    monkeypatch.setattr(fast3r, "Fast3RModel", lambda checkpoint=None, device=None: tf)
    imgs = _imgs(5, 4)
    with jax.enable_x64(False):
        want = jsfv.scene_from_views_factory(stype).reconstruct(imgs)
    sv = tsfv.scene_from_views_factory(stype, device="cpu")
    got = sv.reconstruct(imgs)
    assert got.poses.shape == want.poses.shape == (4, 4, 4)
    assert rel_err(got.poses, want.poses) <= TOL
    assert got.points.shape == want.points.shape and len(got.points) > 0
    assert rel_err(got.points, want.points) <= TOL
    if low is not None:
        kept = sv.kept_views(tv.infer_views(imgs)["anchor_mass"])
        assert kept.tolist() == [True, True, False, True]
        assert len(got.points) < 4 * 32 * 32
