"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: inputs are made with numpy from a seed, and float32 copies go to
both sides (the test session runs JAX with x64 on, so a float64 array would
silently run the reference in float64)."""

import contextlib

import numpy as np
import torch

# the suite runs several xdist workers: keep each one's torch pool small
torch.set_num_threads(2)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def jnp_f32(x):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(x, np.float32))


def t(x) -> torch.Tensor:
    """A CPU tensor copy of a numpy array (float64 becomes float32)."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def np_(x) -> np.ndarray:
    """numpy view of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def synth_image(r: np.random.Generator, h: int = 240, w: int = 320, n_blobs: int = 80):
    """Random rectangles on a gradient background (the generator of
    tests/test_features.py)."""
    img = np.tile(np.linspace(40, 90, w, dtype=np.float32), (h, 1))
    for _ in range(n_blobs):
        y = r.integers(20, h - 40)
        x = r.integers(20, w - 40)
        bh = r.integers(6, 24)
        bw = r.integers(6, 24)
        img[y : y + bh, x : x + bw] = r.uniform(120, 250)
    return img


class JaxKeySampler:
    """Minimal samples as the JAX package draws them: one split of a
    ``PRNGKey(seed)`` per call, then its ``_sample_minimal`` with x64 off (as
    ``LoopClosing.geometry_check`` and ``Relocalizer.relocalize`` split
    theirs).  The port's ``LoopClosing`` and ``Relocalizer`` take it as
    ``sampler``, so both packages solve from the same minimal sets."""

    def __init__(self, seed: int):
        import jax

        self.key = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self, valid, num_hyp, sample_size, weights=None):
        import jax
        import jax.numpy as jnp

        from pyslam_tpu.ops.epipolar import _sample_minimal

        with jax.enable_x64(False):
            self.key, k = jax.random.split(self.key)
            s = _sample_minimal(k, jnp.asarray(np_(valid)), num_hyp, sample_size,
                                weights=None if weights is None else jnp.asarray(np_(weights)))
        self.calls += 1
        return torch.from_numpy(np.asarray(s).astype(np.int64)).to(valid.device)


def flat_variables(variables) -> dict:
    """A flax variable tree as the JAX package flattens it for its ``.npz``
    files (``params/...`` keys, numpy leaves): the input of the
    ``pyslam_tpu_torch.interop.*_state_dict`` converters."""
    from pyslam_tpu.models.torch_convert import flatten_tree

    return flatten_tree(dict(variables))


def assert_same_features(ref, got, tol: float, xy_tol: float = 0.0, min_valid: int = 1,
                         min_same: float = 1.0):
    """FeatureData of the JAX package (``ref``) and of the port (``got``):
    the same keypoint slots (valid flag, and coordinates exactly or within
    ``xy_tol`` px) on at least ``min_same`` of them, the others at
    responses within ``tol`` (near-ties of the score map that float32
    rounding orders either way); responses and the shared valid slots'
    descriptors within ``tol``."""
    valid = np.asarray(ref.valid)
    assert valid.sum() >= min_valid, valid.sum()
    same = ((np.abs(np_(got.xy) - np.asarray(ref.xy)).max(1) <= xy_tol)
            & (np_(got.valid) == valid))
    assert same.mean() >= min_same, (same.mean(), np.abs(np_(got.xy) - np.asarray(ref.xy)).max())
    assert np.abs(np_(got.response) - np.asarray(ref.response)).max() <= tol
    shared = same & valid
    assert np.abs(np_(got.desc)[shared] - np.asarray(ref.desc)[shared]).max() <= tol


def rel_err(got, want) -> float:
    """max |got - want| over the largest magnitude of ``want``."""
    got, want = np_(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@contextlib.contextmanager
def compiled_flax_init():
    """Build a JAX-package extractor with its flax ``init`` (and the
    ``apply`` calls of its constructor) compiled by ``jax.jit`` instead of
    run op by op: the same variables, several times faster to make."""
    import jax
    import flax.linen as nn

    orig_init, orig_apply = nn.Module.init, nn.Module.apply

    def init(self, rngs, *args, **kw):
        return jax.jit(lambda r, *a: orig_init(self, r, *a, **kw))(rngs, *args)

    def apply(self, variables, *args, **kw):
        return jax.jit(lambda v, *a: orig_apply(self, v, *a, **kw))(variables, *args)

    nn.Module.init, nn.Module.apply = init, apply
    try:
        yield
    finally:
        nn.Module.init, nn.Module.apply = orig_init, orig_apply
