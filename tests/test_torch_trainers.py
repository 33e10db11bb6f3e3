"""The port's trainers (pyslam_tpu_torch/models/train_{superpoint,lightglue,
cosplace}.py) against the JAX package's, on the CPU.

- The numpy data generators give identical arrays.
- One training step from the same parameters (the JAX init carried
  across) and the same draws (SuperPoint's batch indices and CosPlace's
  place centres as ``jax.random`` draws them, injected): the loss within
  1e-5 of the reference's (read inside its jitted step by a
  ``jax.debug.callback`` on its ``jax.value_and_grad``), and the
  parameters after the step within 1e-6 in at least 99.9 % of their
  entries and within 2 lr in all of them (Adam's first step is about lr
  times the gradient's sign, so a gradient that rounding puts on the other
  side of zero moves by 2 lr).  The CosPlace batch norms' running
  statistics train in both.
- LightGlue's ``loss_fn`` (vmapped over a batch) and its gradient against
  the reference's ``jax.value_and_grad`` of its own, recorded in that
  step, within 1e-4 of the largest magnitude.
- ``ops/adam.py``'s clip + cosine decay + Adam against ``optax`` on the
  same 10 gradients, within 1e-6.
- The JAX SuperPoint trainer's batch draws saved for ``chip_smoke.py``
  (``tests/data/superpoint_reference_draws.npy``) equal JAX's.
- A checkpoint the port trains (one step from the bundled weights;
  LightGlue's from a seeded init at the small width) loads in the JAX
  package's extractor or matcher and in the port's, with the same
  outputs.

The JAX side runs with x64 off, its flax inits compiled
(``tests.torch_parity.compiled_flax_init``).  The one-step comparison
runs LightGlue at 2 layers of width 32 (both packages' module constants
patched alike), to keep the reference's XLA compilation short.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyslam_tpu.models.train_cosplace as jcp
import pyslam_tpu.models.train_lightglue as jlg
import pyslam_tpu.models.train_superpoint as jsp
import pyslam_tpu_torch.models.train_cosplace as tcp
import pyslam_tpu_torch.models.train_lightglue as tlg
import pyslam_tpu_torch.models.train_superpoint as tsp
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.ops import adam
from tests.torch_parity import compiled_flax_init, flat_variables, np_
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

LR = 1e-3


@contextlib.contextmanager
def recorded_losses():
    """Record the loss and the gradient of every ``jax.value_and_grad``
    call the reference makes while tracing (inside its jitted step), as it
    runs."""
    got, orig = [], jax.value_and_grad

    def value_and_grad(fn, **kw):
        inner = orig(fn, **kw)

        def run(p):
            out = inner(p)
            value = out[0][0] if kw.get("has_aux") else out[0]
            jax.debug.callback(lambda v, g: got.append((float(v), flat_variables(g))),
                               value, out[1])
            return out
        return run

    jax.value_and_grad = value_and_grad
    try:
        yield got
    finally:
        jax.value_and_grad = orig


@contextlib.contextmanager
def small(modules, **values):
    """Both packages' trainer constants set to ``values`` for the block."""
    saved = [(m, {k: getattr(m, k) for k in values}) for m in modules]
    for m in modules:
        for k, v in values.items():
            setattr(m, k, v)
    try:
        yield
    finally:
        for m, old in saved:
            for k, v in old.items():
                setattr(m, k, v)


SMALL_LIGHTGLUE = dict(DIM=32, LAYERS=2)


# ---------------------------------------------------------------- generators
def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("trainer", ["superpoint", "lightglue", "cosplace"])
def test_data_generators_identical(trainer):
    if trainer == "superpoint":
        for a, b in zip(jsp.make_batch(np.random.default_rng(4), 3),
                        tsp.make_batch(np.random.default_rng(4), 3)):
            _same(a, b)
        _same(jsp.cell_centers(), tsp.cell_centers())
        _same(tsp.cell_centers(), np_(tsp._centers("cpu")))
        corners = np.array([[3.5, 9.0], [150.2, 100.7]], np.float32)
        _same(jsp.cells_target(corners), tsp.cells_target(corners))
    elif trainer == "lightglue":
        for a, b in zip(jlg.make_batch(np.random.default_rng(4), 3, 16),
                        tlg.make_batch(np.random.default_rng(4), 3, 16)):
            _same(a, b)
    else:
        tex = jcp.place_texture(1003)
        _same(tex, tcp.place_texture(1003))
        _same(jcp._normalize(jcp.render_view(tex, np.random.default_rng(4))),
              tcp._normalize(tcp.render_view(tex, np.random.default_rng(4))))
        # a step's views, as the port's trainer samples them on the device
        texs = np.stack([tex, jcp.place_texture(1004)])
        which = [1, 0, 1, 1]
        r, r2 = np.random.default_rng(5), np.random.default_rng(5)
        want = np.stack([jcp._normalize(jcp.render_view(texs[i], r)) for i in which])
        _same(want, np_(tcp.normalized_views(torch.from_numpy(texs), which, r2)))
        assert r.random() == r2.random()   # the generators left in the same state


# ----------------------------------------------------------- one train step
_STEPS = {}


def _step(trainer):
    """(init, reference params, [(loss, gradient)], port params, port
    loss) of one step, once a test run."""
    if trainer not in _STEPS:
        _STEPS[trainer] = {"superpoint": _superpoint_step, "lightglue": _lightglue_step,
                           "cosplace": _cosplace_step}[trainer]()
    return _STEPS[trainer]


def _superpoint_step():
    from pyslam_tpu.models.superpoint import SuperPointNet

    with jax.enable_x64(False):
        with compiled_flax_init():
            init = SuperPointNet().init(jax.random.PRNGKey(5), jnp.zeros((jsp.H, jsp.W, 1)))
        _, k = jax.random.split(jax.random.PRNGKey(1))
        idx = np.asarray(jax.random.randint(k, (2,), 0, 6))
        with recorded_losses() as ref_loss:
            ref = jsp.train(steps=1, batch=2, n_dataset=6, init_params=init)
    losses = []
    got = tsp.train(steps=1, batch=2, n_dataset=6, device="cpu", indices=[idx], losses=losses,
                    init_params=interop.superpoint_state_dict(flat_variables(init)))
    return init, ref, ref_loss, interop.superpoint_flat(got), float(losses[0][0])


def _lightglue_step():
    with small((jlg, tlg), **SMALL_LIGHTGLUE):
        return _lightglue_step_small()


def _lightglue_step_small():
    m = jnp.ones((jlg.N_KPS,), bool)
    z, zx = jnp.zeros((jlg.N_KPS, jlg.DESC_DIM)), jnp.zeros((jlg.N_KPS, 2))
    with jax.enable_x64(False):
        with compiled_flax_init():
            init = jlg.build_net().init(jax.random.PRNGKey(0), z, zx, m, z, zx, m)
        with recorded_losses() as ref_loss:
            _, ref = jlg.train(steps=1, batch=2, seed=0)
    losses = []
    _, got = tlg.train(steps=1, batch=2, seed=0, device="cpu", losses=losses,
                       init_params=interop.lightglue_state_dict(flat_variables(init)))
    return init, ref, ref_loss, interop.lightglue_flat(got), float(losses[0])


def _cosplace_step():
    with jax.enable_x64(False):
        with compiled_flax_init():
            init = jcp.build_net().init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, jcp.VIEW_H, jcp.VIEW_W, 3)))
        centers = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                               (jcp.N_PLACES, jcp.OUT_DIM)) * 0.05)
        with recorded_losses() as ref_loss:
            _, ref = jcp.train(steps=1, batch=3, seed=0)
    losses = []
    _, got = tcp.train(steps=1, batch=3, seed=0, device="cpu", centers=centers, losses=losses,
                       init_params=interop.cosplace_state_dict(flat_variables(init)))
    return init, ref, ref_loss, interop.cosplace_flat(got), float(losses[0])


@pytest.mark.parametrize("trainer", ["superpoint", "lightglue", "cosplace"])
def test_one_step_matches_the_reference(trainer):
    init, ref, ref_loss, got, loss = _step(trainer)
    assert len(ref_loss) == 1
    assert abs(loss - ref_loss[0][0]) <= 1e-5, (loss, ref_loss[0][0])
    ref, init = flat_variables(ref), flat_variables(init)
    assert set(got) == set(ref)
    close = total = 0
    for k, v in ref.items():
        d = np.abs(got[k] - v)
        assert d.max() <= 2 * LR + 1e-6, (k, d.max())
        close += int((d <= 1e-6).sum())
        total += d.size
    assert close >= 0.999 * total, close / total
    moved = [k for k in ref if not np.array_equal(got[k], init[k])]
    assert len(moved) == len(ref)
    if trainer == "cosplace":
        stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 2 * sum(k.endswith("/weight") for k in ref), stats


def test_lightglue_loss_and_gradient():
    """The port's ``batch_loss`` (``loss_fn`` over the first step's two
    pairs, in one vmap) and its gradient against the reference step's
    ``jax.value_and_grad`` of its vmapped ``loss_fn``, from the same
    parameters."""
    init, _, ref_loss, _, _ = _step("lightglue")
    (loss, grad), = ref_loss
    with small((tlg,), **SMALL_LIGHTGLUE):
        net = tlg.build_net()
    net.load_state_dict(interop.lightglue_state_dict(flat_variables(init)))
    p = dict(net.named_parameters())
    batch = tlg.make_batch(np.random.default_rng(0), 2, 64)   # the first step's
    tl = tlg.batch_loss(net, p, *map(torch.from_numpy, batch))
    tg = interop.lightglue_flat(dict(zip(p, torch.autograd.grad(tl, list(p.values())))))
    assert abs(tl.item() - loss) <= 1e-4 * abs(loss)
    scale = max(np.abs(v).max() for v in grad.values())
    assert set(tg) == set(grad)
    assert max(np.abs(tg[k] - v).max() for k, v in grad.items()) <= 1e-4 * scale


def test_superpoint_reference_draws_file():
    """The JAX trainer's batch draws that chip_smoke.py 20a feeds the port
    (tests/torch_jax_draws.py), against JAX."""
    from tests.torch_jax_draws import PATH, superpoint_draws

    assert np.array_equal(np.load(PATH), superpoint_draws())


def test_clip_cosine_adam_match_optax():
    """10 updates of the LightGlue trainer's optimiser (the schedule over 8
    steps, so its clamp is reached), gradient norms on either side of 1."""
    import optax

    r = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (7,)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (0.05, 1.0, 0.2, 3.0, 0.01, 0.5, 2.0, 0.1, 0.3, 5.0)]
    with jax.enable_x64(False):
        opt = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adam(optax.cosine_decay_schedule(1e-2, 8)))
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        st = opt.init(jp)
        ref = []
        for g in grads:
            u, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st)
            jp = optax.apply_updates(jp, u)
            ref.append({k: np.asarray(v) for k, v in jp.items()})
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = adam.init_state(tp)
    for g, want in zip(grads, ref):
        clipped = adam.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        adam.adam_step_(tp, clipped, state, adam.cosine_decay(1e-2, 8, state.count))
        for k in shapes:
            assert np.abs(np_(tp[k]) - want[k]).max() <= 1e-6, k


# ------------------------------------------------------ checkpoints carried
def _bundled(name, convert):
    return convert(interop.read_npz(interop.bundled_checkpoint(name)))


@pytest.mark.parametrize("model", ["superpoint", "lightglue", "cosplace"])
def test_port_checkpoint_loads_in_both_packages(model, tmp_path):
    path = str(tmp_path / f"{model}.npz")
    img = np.round(np.random.default_rng(9).uniform(0, 255, (96, 128))).astype(np.float32)
    if model == "superpoint":
        from pyslam_tpu.models.superpoint import SuperPointExtractor as Jax
        from pyslam_tpu_torch.models.superpoint import SuperPointExtractor

        state = tsp.train(steps=1, batch=2, n_dataset=4, device="cpu",
                          init_params=_bundled("superpoint_tiny", interop.superpoint_state_dict))
        tsp.save_checkpoint(path, state)
        with jax.enable_x64(False), compiled_flax_init():
            ref = Jax(num_features=200, checkpoint=path)
            det, desc = ref.net.apply(ref.params, jnp.asarray(img)[..., None] / 255.0)
        got = SuperPointExtractor(num_features=200, checkpoint=path, device="cpu")
        with torch.no_grad():
            det_t, desc_t = got.net(torch.from_numpy(img)[None, None] / 255.0)
        assert np.abs(np_(det_t[0]).transpose(1, 2, 0) - np.asarray(det)).max() <= 1e-4
        assert np.abs(np_(desc_t[0]).transpose(1, 2, 0) - np.asarray(desc)).max() <= 1e-4
    elif model == "lightglue":
        from pyslam_tpu.models.lightglue import LightGlueMatcher as Jax
        from pyslam_tpu_torch.models.lightglue import LightGlueMatcher

        with small((tlg,), **SMALL_LIGHTGLUE):   # from a seeded init, at the small width
            _, state = tlg.train(steps=1, batch=2, device="cpu")
            tlg.save_checkpoint(path, state)
            dim, layers = tlg.DIM, tlg.LAYERS
        assert int(np.load(path)["__dim__"]) == dim
        d0, xy0, d1, xy1, _ = tlg.make_pair(np.random.default_rng(5))
        c = np.array([tlg.W / 2, tlg.H / 2], np.float32)
        m = np.ones((tlg.N_KPS,), bool)
        with jax.enable_x64(False), compiled_flax_init():
            ref = Jax(dim=dim, layers=layers, checkpoint=path)
            want, _ = ref.net.apply(ref.params, d0, (xy0 - c) / c.max(), m, d1,
                                    (xy1 - c) / c.max(), m)
        got = LightGlueMatcher(dim=dim, layers=layers, checkpoint=path, device="cpu")
        assert got.trained   # the reference reports trained only for its bundled file
        with torch.no_grad():
            s, _ = got.net(*(torch.from_numpy(np.asarray(a)) for a in (
                d0, (xy0 - c) / c.max(), m, d1, (xy1 - c) / c.max(), m)))
        assert np.abs(np_(s) - np.asarray(want)).max() <= 1e-4 * np.abs(np.asarray(want)).max()
    else:
        from pyslam_tpu.models.cosplace import CosPlaceExtractor as Jax
        from pyslam_tpu_torch.models.cosplace import CosPlaceExtractor

        _, state = tcp.train(steps=1, batch=2, device="cpu",
                             init_params=_bundled("cosplace_tiny", interop.cosplace_state_dict))
        tcp.save_checkpoint(path, state)
        with jax.enable_x64(False):
            with compiled_flax_init():
                ref = Jax(checkpoint=path, image_hw=(96, 128))
            want = np.asarray(ref(img))
        got = CosPlaceExtractor(checkpoint=path, image_hw=(96, 128), device="cpu")
        assert got.trained and got.out_dim == tcp.OUT_DIM
        assert np.abs(got(img) - want).max() <= 1e-5
