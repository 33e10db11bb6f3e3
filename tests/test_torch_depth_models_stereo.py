"""The recurrent stereo networks and MV-DUSt3R of the port
(pyslam_tpu_torch/models/{raft_stereo,crestereo,mvdust3r}.py) against the
JAX package's, split from tests/test_torch_depth_models.py (whose
docstring states the sizes and tolerances, and whose constants these
tests use), so that the xdist workers share the depth models' time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models import crestereo as jcre
from pyslam_tpu.models import mvdust3r as jmv
from pyslam_tpu.models import raft_stereo as jraft
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import crestereo, mvdust3r, raft_stereo
from tests.test_torch_depth_models import CRE_TINY, MV_SMALL, RAFT_TINY, STEREO_TOL, TOL, _carry
from tests.torch_parity import compiled_flax_init, np_, rel_err, rng, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)


def _pyramid(seed, h=4, w=24, d=8, levels=3):
    r = rng(seed)
    f1, f2 = r.normal(size=(2, h, w, d)).astype(np.float32)
    with jax.enable_x64(False):
        jp = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels)
    pp = raft_stereo.corr_pyramid(t(f1), t(f2), levels)
    return jp, pp


def test_raft_corr_pyramid():
    jp, pp = _pyramid(9)
    for a, b in zip(jp, pp):
        assert a.shape == tuple(b.shape) and rel_err(b, a) <= 1e-5


def test_raft_lookup_off_edges():
    """Disparities that push the taps off both edges of every level: the
    left index is clipped before the fraction is taken (extrapolation)."""
    jp, pp = _pyramid(10)
    r = rng(11)
    disp = r.uniform(-30.0, 60.0, (4, 24)).astype(np.float32)
    disp[0] = 50.0                       # every tap left of column 0
    disp[1] = -20.0                      # every tap right of the last column
    with jax.enable_x64(False):
        want = jraft.lookup(jp, jnp.asarray(disp), 3)
    got = raft_stereo.lookup(pp, t(disp), 3)
    assert np.abs(np_(got) - np.asarray(want)).max() <= 1e-5 * np.abs(want).max()


def test_raft_convex_upsample():
    r = rng(12)
    disp = r.uniform(0, 5, (6, 8)).astype(np.float32)
    mask = r.normal(size=(6, 8, 144)).astype(np.float32)
    with jax.enable_x64(False):
        want = jraft.convex_upsample(jnp.asarray(disp), jnp.asarray(mask))
    assert rel_err(raft_stereo.convex_upsample(t(disp), t(mask)), want) <= 1e-5


def _stereo_pair(seed, h=48, w=64, disp=4):
    tex = rng(seed).uniform(0, 255, (h, w + 16)).astype(np.float32)
    return tex[:, 8:8 + w], tex[:, 8 - disp:8 - disp + w]


@pytest.fixture(scope="module")
def raft():
    cfg = jraft.RaftStereoConfig(**RAFT_TINY)
    with jax.enable_x64(False), compiled_flax_init():
        ref = jraft.RaftStereo(cfg)
        ref._ensure_params((48, 64))
    got = raft_stereo.RaftStereo(raft_stereo.RaftStereoConfig(**RAFT_TINY), device="cpu")
    _carry(ref.params, got.net, interop.raft_stereo_state_dict)
    return ref, got


def test_raft_infer(raft):
    ref, got = raft
    left, right = _stereo_pair(13, 50, 70)          # cropped to 48 x 64
    with jax.enable_x64(False):
        want = ref.infer(left, right)
    out = got.infer(left, right)
    assert out.shape == (50, 70) and (out[48:] == 0).all() and (out[:, 64:] == 0).all()
    assert rel_err(out, want) <= STEREO_TOL


def test_raft_odd_pyramid_width():
    """A width whose quarter halves to an odd level (KITTI's 1232 crop at 4
    levels: 308, 154, 77): the reference cannot reshape it and raises; the
    port drops the odd column (the official RAFT-Stereo's pooling) and
    runs."""
    with jax.enable_x64(False), pytest.raises(TypeError):
        jraft.corr_pyramid(jnp.zeros((12, 10, 8)), jnp.zeros((12, 10, 8)), 3)
    pyr = raft_stereo.corr_pyramid(torch.zeros(12, 10, 8), torch.zeros(12, 10, 8), 3)
    assert [p.shape[2] for p in pyr] == [10, 5, 2]
    cfg = raft_stereo.RaftStereoConfig(**dict(RAFT_TINY, corr_levels=3))
    net = interop.seeded_init_(raft_stereo.RaftStereoNet(cfg), 0).eval()
    left, right = _stereo_pair(14, 48, 40)          # quarter 10 -> 5 -> 2
    with torch.no_grad():
        d = net(t(left / 255.0), t(right / 255.0))
    assert d.shape == (48, 40) and torch.isfinite(d).all()


def test_crestereo_group_corr_off_edges():
    """Windows that run off both edges: the fraction is taken from the
    unclipped floor, then the indices are clipped."""
    r = rng(15)
    f1, f2 = r.normal(size=(2, 5, 20, 8)).astype(np.float32)
    disp = r.uniform(-15.0, 35.0, (5, 20)).astype(np.float32)
    disp[0], disp[1] = 30.0, -12.0
    off = r.uniform(-2, 2, (5, 20, 2)).astype(np.float32)
    with jax.enable_x64(False):
        want = jcre._group_corr_window(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(disp),
                                       jnp.asarray(off), 4, 2)
    got = crestereo._group_corr_window(t(f1), t(f2), t(disp), t(off), 4, 2)
    assert np.abs(np_(got) - np.asarray(want)).max() <= 1e-5 * np.abs(want).max()


@pytest.fixture(scope="module")
def cre():
    cfg = jcre.CREStereoConfig(**CRE_TINY)
    with jax.enable_x64(False), compiled_flax_init():
        ref = jcre.CREStereo(cfg)
        ref._ensure_params((40, 56))
    got = crestereo.CREStereo(crestereo.CREStereoConfig(**CRE_TINY), device="cpu")
    _carry(ref.params, got.net, interop.crestereo_state_dict)
    return ref, got


def test_crestereo_infer(cre):
    ref, got = cre
    left, right = _stereo_pair(16, 37, 53)          # zero-padded to 40 x 56
    with jax.enable_x64(False):
        want = ref.infer(left, right)
    out = got.infer(left, right)
    assert out.shape == (37, 53) and np.isfinite(out).all()
    assert rel_err(out, want) <= STEREO_TOL


@pytest.fixture(scope="module")
def mv():
    cfg = jmv.MVDust3rConfig(**MV_SMALL)
    with jax.enable_x64(False), compiled_flax_init():
        ref = jmv.MVDust3rModel(cfg, num_refs=2)
    got = mvdust3r.MVDust3rModel(mvdust3r.MVDust3rConfig(**MV_SMALL), num_refs=2, device="cpu")
    _carry(ref.params, got.net, interop.mvdust3r_state_dict)
    return ref, got


@pytest.mark.parametrize("n_views", [1, 3])
def test_mvdust3r_infer_views(mv, n_views):
    ref, got = mv
    r = rng(17)
    imgs = [r.uniform(0, 255, (80, 96, 3)).astype(np.float32) for _ in range(n_views)]
    with jax.enable_x64(False):
        want = ref.infer_views(imgs)
    out = got.infer_views(imgs)
    assert out["ref_index"] == want["ref_index"]
    for k in ("points", "conf", "local_points", "local_conf"):
        assert rel_err(out[k], want[k]) <= TOL, k
    assert np.abs(out["poses"] - want["poses"]).max() <= 1e-3
