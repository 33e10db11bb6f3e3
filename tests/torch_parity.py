"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: inputs are made with numpy from a seed, and float32 copies go to
both sides (the test session runs JAX with x64 on, so a float64 array would
silently run the reference in float64)."""

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
