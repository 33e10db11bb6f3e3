"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: inputs are made with numpy from a seed, and float32 copies go to
both sides (the test session runs JAX with x64 on, so a float64 array would
silently run the reference in float64)."""

import contextlib
import os

import numpy as np
import pytest
import torch

# the suite runs several xdist workers: keep each one's torch pool small
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def shared_jax_compile_cache(tmp_path_factory):
    """JAX's persistent compilation cache for the module that imports this
    fixture: the JAX references that several port test files build (the
    same flax models, the same JAX ``Slam`` graphs) compile once a test run
    and are read back by every other xdist worker, in a directory the run's
    workers share (beside their own base temporary directories), which a
    new run starts empty.  Off again after the module, so the JAX package's
    own test files run as they always have.  A cache entry that fails to
    load is compiled anew (JAX warns)."""
    import jax
    from jax._src import compilation_cache

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "jax_compile_cache"
    path.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    compilation_cache.reset_cache()
    try:
        yield path
    finally:
        jax.config.update("jax_compilation_cache_dir", None)
        compilation_cache.reset_cache()


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
def reference_polls_like_the_port():
    """Make the JAX package's local mapping see its device results ready by
    the port's CPU rule (``pyslam_tpu_torch.slam.local_mapping.Pending``)
    instead of by ``jax.Array.is_ready``, whose answer follows the host's
    load, so that the reference's keyframe cadence and map do not move with
    the busy processes beside it.  A triangulation result is ready once an
    end-of-frame back-end step has run since its dispatch, a fuse result
    and an LBA chunk from the next back-end call on; a result taken as ready
    is then awaited, so it is the value the device computed."""
    from pyslam_tpu.slam.local_mapping import LocalMapping

    clock = {"calls": 0, "frames": 0}
    orig = {name: getattr(LocalMapping, name) for name in (
        "step_async", "_tri_dispatch", "_fuse_dispatch", "_lba_dispatch", "_lba_poll",
        "_advance_slice")}

    def tick():
        return clock["calls"], clock["frames"]

    def stamped(name):
        def dispatch(self, *a, **kw):
            job = orig[name](self, *a, **kw)
            if job is not None:
                job["tick"] = tick()
            return job
        return dispatch

    def step_async(self, start_new_jobs=True):
        clock["calls"] += 1
        clock["frames"] += int(start_new_jobs)
        return orig["step_async"](self, start_new_jobs)

    def lba_dispatch(self, *a, **kw):
        orig["_lba_dispatch"](self, *a, **kw)
        if self._lba is not None:
            self._lba["tick"] = tick()

    def lba_poll(self, block):
        if not block and self._lba["tick"][0] >= clock["calls"]:
            return False
        lba = self._lba
        done = orig["_lba_poll"](self, True)
        if self._lba is lba:   # the next chunk was dispatched
            lba["tick"] = tick()
        return done

    def advance_slice(self, block=False):
        if not block and self._job_stage == 2:
            if self._tri_job["tick"][1] >= clock["frames"]:
                return False
            block = True
        elif not block and self._job_stage == 4:
            if self._fuse_job["tick"][0] >= clock["calls"]:
                return False
            block = True
        return orig["_advance_slice"](self, block)

    patched = dict(step_async=step_async, _tri_dispatch=stamped("_tri_dispatch"),
                   _fuse_dispatch=stamped("_fuse_dispatch"), _lba_dispatch=lba_dispatch,
                   _lba_poll=lba_poll, _advance_slice=advance_slice)
    for name, fn in patched.items():
        setattr(LocalMapping, name, fn)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(LocalMapping, name, fn)


@contextlib.contextmanager
def port_extracts_from_the_reference_pyramid():
    """Make the port's ORB2 extraction start from the JAX package's image
    pyramid (``pyslam_tpu.ops.image.build_pyramid``, x64 off) for every
    image, as ``tests/torch_orb2_ties.py`` does for one frame.  The port's
    pyramid column pass keeps one FMA chain, within 3.05e-5 grey levels of
    the reference's (an accepted deviation, ROADMAP.md section 3); this
    takes it out of a comparison of the two packages' sessions.  The
    pyramid is jitted, as inside the reference's extraction (bit for bit
    the op-by-op result, and much faster)."""
    import jax
    import jax.numpy as jnp

    from pyslam_tpu.ops import image as jax_image
    from pyslam_tpu_torch.features import orb2

    orig = orb2.extract_batch
    build = jax.jit(jax_image.build_pyramid, static_argnums=(1, 2))

    def extract_batch(imgs, num_features, num_levels, scale, fast_th, cell, per_cell):
        with jax.enable_x64(False):
            pyrs = [build(jnp.asarray(np_(img)), num_levels, scale) for img in imgs]
        pyr = [torch.stack([torch.from_numpy(np.array(p[lv])) for p in pyrs]).to(imgs.device)
               for lv in range(num_levels)]
        return orb2.extract_pyramid(pyr, num_features, scale, fast_th, cell, per_cell)

    orb2.extract_batch = extract_batch
    try:
        yield
    finally:
        orb2.extract_batch = orig


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
