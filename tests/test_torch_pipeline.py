"""The port's ``frontend_step`` (``pyslam_tpu_torch/pipeline.py``) against
``pyslam_tpu.pipeline.frontend_step`` with ``use_pallas=False`` (x64 off,
as the JAX package runs outside this suite), 300 features on 4 levels.

- ``__graft_entry__.py``'s draw at 120x160 with a 256-point map (noise
  image, random map): keypoints, descriptor bits and matches identical;
- a real case: a 240x320 synthetic frame against a map made of the
  previous frame's keypoints and descriptors, its prediction 5 cm off.
  Fed the reference's pyramid, keypoints, bits and matches are identical
  and ``Tcw_opt`` within 1e-4, the tolerance of the pose optimisation's
  parity test (test_torch_optim.py).  On the port's own pyramid, whose
  column pass sums in another order than XLA's (test_torch_orb2.py), >= 99 %
  of the keypoints are identical and the inliers within 2 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.ops import image as jimage
from pyslam_tpu.pipeline import frontend_step as jax_frontend_step
from pyslam_tpu_torch.features import orb2 as torb2
from pyslam_tpu_torch.pipeline import frontend_step
from tests.torch_parity import f32
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

NF, NL = 300, 4


def _both(args):
    with jax.enable_x64(False):
        ref = jax_frontend_step(*[jnp.asarray(a) for a in args], num_features=NF, num_levels=NL,
                                use_pallas=False)
        ref = jax.tree.map(np.asarray, ref)
    got = frontend_step(*args, num_features=NF, num_levels=NL, device="cpu")
    got = jax.tree.map(lambda x: x.numpy(), tuple(got))
    return ref, got


def _same_keypoints(ref, got):
    return np.all(ref[0].xy == got[0].xy, 1) & (ref[0].level == got[0].level)


def _reference_pyramid(monkeypatch, img):
    """Make the port's extraction read the reference's pyramid of ``img``."""
    def pyramid(imgs, num_levels, scale):
        with jax.enable_x64(False):
            pyr = jimage.build_pyramid(jnp.asarray(img), num_levels, scale)
        return [torch.from_numpy(np.array(p))[None] for p in pyr]

    monkeypatch.setattr(torb2.image_ops, "build_pyramid", pyramid)


def test_graft_draw():
    r = np.random.default_rng(0)
    h, w, M = 120, 160, 256
    img = r.uniform(0, 255, (h, w)).astype(np.float32)
    pos = np.concatenate([r.uniform(-10, 10, (M, 2)), r.uniform(5, 40, (M, 1))], 1)
    args = (img, f32(pos), r.integers(0, 2, (M, 256)).astype(np.int8), np.ones(M, bool),
            np.eye(4, dtype=np.float32),
            np.array([[718.856, 0, 80.0], [0, 718.856, 60.0], [0, 0, 1]], np.float32))
    ref, got = _both(args)
    assert _same_keypoints(ref, got).all()
    np.testing.assert_array_equal(got[0].desc, ref[0].desc)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-4)
    assert int(got[3]) == int(ref[3])


@pytest.fixture(scope="module")
def real_case():
    ds = JaxSyntheticDataset(num_frames=3)
    K = np.array([[ds.fx, 0, ds.cx], [0, ds.fy, ds.cy], [0, 0, 1]], np.float32)
    img0, img1 = f32(ds.getImage(0)), f32(ds.getImage(1))
    with jax.enable_x64(False):
        f0 = jax.tree.map(np.asarray, jax_frontend_step(
            jnp.asarray(img0), jnp.zeros((1, 3)), jnp.zeros((1, 256), jnp.int8),
            jnp.zeros(1, bool), jnp.eye(4), jnp.asarray(K), num_features=NF, num_levels=NL,
            use_pallas=False)[0])
    sel = np.nonzero(f0.valid)[0][:256]
    z = np.random.default_rng(0).uniform(4.0, 8.0, len(sel))
    xy = f0.xy[sel]
    pos = np.column_stack([(xy[:, 0] - K[0, 2]) / K[0, 0] * z,
                           (xy[:, 1] - K[1, 2]) / K[1, 1] * z, z])
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.05
    return (img1, f32(pos), f0.desc[sel], np.ones(len(sel), bool), T, K)


def test_real_case_on_the_reference_pyramid(real_case, monkeypatch):
    _reference_pyramid(monkeypatch, real_case[0])
    ref, got = _both(real_case)
    assert _same_keypoints(ref, got).all()
    np.testing.assert_array_equal(got[0].desc, ref[0].desc)
    np.testing.assert_array_equal(got[1], ref[1])
    assert (got[1] >= 0).sum() >= 100
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-4)
    assert int(got[3]) == int(ref[3]) >= 100


def test_real_case_on_the_ports_pyramid(real_case):
    ref, got = _both(real_case)
    assert _same_keypoints(ref, got).mean() >= 0.99
    assert abs(int(got[3]) - int(ref[3])) <= 0.02 * int(ref[3])
