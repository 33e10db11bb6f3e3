"""LoFTR in the port (pyslam_tpu_torch/models/loftr.py) against the JAX
package's, with its ``PRNGKey(0)`` weights carried across
(``interop.loftr_state_dict``) and its batch-norm statistics randomised in
both: the sizes of tests/test_loftr.py (dims 16/24/32, one coarse pair, 4
heads; the backbone at 64x64, the matcher at 64x96 with
``conf_threshold`` 0 and 64 matches), the JAX package run with x64 off.

Tolerances: the backbone's coarse and fine maps and the coarse
transformer's features within 1e-5 of their largest magnitude; the dual
softmax's ``conf_all`` within 1e-5 absolute (it lies in [0, 1]); the
coarse matches (``top_i1``, ``top_i2``) identical; the fine ``xy2`` within
1e-4 px.  ``loftr_from_torch`` loads a state dict under the official
names (``matcher.`` prefix, batch counters, the position encoding's
buffer) into the port, and the JAX package's converter the same dict:
the two compute the same matches.  ``LoftrFeatureTracker.track_pair`` at
the preset's full width on a 64x96 input, both packages, ``conf_threshold``
0: the same points.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models import loftr as jloftr
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import loftr
from pyslam_tpu_torch.models.torch_convert import loftr_from_torch
from tests.torch_parity import compiled_flax_init, flat_variables, rel_err, rng
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-5
XY_TOL = 1e-4
DIMS = (16, 24, 32)
CFG = jloftr.LoFTRConfig(img_hw=(64, 96), dims=DIMS, coarse_layers=1, heads=4,
                         conf_threshold=0.0, max_matches=64)


def _port_cfg(cfg):
    return loftr.LoFTRConfig(**dataclasses.asdict(cfg))


def _randomize_bn(variables, seed=1):
    """Random running statistics, scales and shifts for every BN (the JAX
    init leaves them at 0 / 1)."""
    r = rng(seed)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
    for path, v in flat.items():
        n = np.asarray(v).shape
        if path[-1] == "running_mean":
            flat[path] = jnp.asarray(r.normal(0, 0.3, n).astype(np.float32))
        elif path[-1] == "running_var":
            flat[path] = jnp.asarray(r.uniform(0.5, 2.0, n).astype(np.float32))
        elif path[-1] in ("weight", "bias") and "bn" in path[-2]:
            flat[path] = jnp.asarray(r.normal(1.0 if path[-1] == "weight" else 0.0, 0.2,
                                              n).astype(np.float32))
    return flax.traverse_util.unflatten_dict(flat)


def _pair():
    r = rng(0)
    img = r.uniform(0, 255, (64, 96)).astype(np.float32)
    img[20:40, 30:60] += 90
    img = np.clip(img, 0, 255)
    return img, np.roll(img, 3, axis=1)


@pytest.fixture(scope="module")
def nets():
    """(JAX net, its variables, the port's net with them, the port's matcher)."""
    h, w = CFG.img_hw
    jnet = jloftr.LoFTRNet(CFG)
    with jax.enable_x64(False), compiled_flax_init():
        variables = _randomize_bn(jnet.init(jax.random.PRNGKey(0), jnp.zeros((h, w)),
                                            jnp.zeros((h, w))))
    m = loftr.LoFTRMatcher(_port_cfg(CFG), device="cpu")
    assert not m.trained
    m.net.load_state_dict(interop.loftr_state_dict(flat_variables(variables)))
    return jnet, variables, m


def test_backbone(nets):
    jnet, variables, m = nets
    x = rng(2).normal(0, 1, (1, 64, 96, 1)).astype(np.float32)
    with jax.enable_x64(False):
        jc, jf = jax.jit(jloftr.ResNetFPN_8_2(DIMS).apply)(
            {"params": variables["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        c, f = m.net.backbone(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert rel_err(c.permute(0, 2, 3, 1), jc) <= TOL
    assert rel_err(f.permute(0, 2, 3, 1), jf) <= TOL


def test_transformer(nets):
    _, variables, m = nets
    r = rng(3)
    f0 = r.normal(0, 1, (40, DIMS[2])).astype(np.float32)
    f1 = r.normal(0, 1, (40, DIMS[2])).astype(np.float32)
    with jax.enable_x64(False):
        g0, g1 = jax.jit(jloftr.LocalFeatureTransformer(DIMS[2], 4, 1).apply)(
            {"params": variables["params"]["coarse"]}, jnp.asarray(f0), jnp.asarray(f1))
    with torch.no_grad():
        w0, w1 = m.net.loftr_coarse(torch.from_numpy(f0), torch.from_numpy(f1))
    assert rel_err(w0, g0) <= TOL and rel_err(w1, g1) <= TOL


def _ref_run(jnet, variables, a, b):
    """The JAX net's outputs and its coarse matching, from the coarse
    transformer's features it captured (the reference's formulas)."""
    with jax.enable_x64(False):
        out, state = jax.jit(lambda v, x, y: jnet.apply(v, x, y, capture_intermediates=True))(
            variables, jnp.asarray(a), jnp.asarray(b))
        f1, f2 = state["intermediates"]["coarse"]["__call__"][0]
        f1n = f1 / jnp.maximum(jnp.linalg.norm(f1, axis=1, keepdims=True), 1e-6)
        f2n = f2 / jnp.maximum(jnp.linalg.norm(f2, axis=1, keepdims=True), 1e-6)
        S = (f1n @ f2n.T) / CFG.temperature
        P = jax.nn.softmax(S, axis=0) * jax.nn.softmax(S, axis=1)
        return [np.asarray(o) for o in out], np.asarray(jnp.max(P, 1)), np.asarray(
            jnp.argmax(P, 1))


def test_coarse_and_fine_matches(nets):
    jnet, variables, m = nets
    img1, img2 = _pair()
    (rxy1, rxy2, rconf, rvalid), rconf_all, rnn12 = _ref_run(
        jnet, variables, m.prep(img1).numpy(), m.prep(img2).numpy())
    with torch.no_grad():
        f1, f2, _ = m.net.coarse(m.prep(img1), m.prep(img2))
        nn12, conf_all, top_conf, top_i1 = m.net.match_coarse(f1, f2)
    assert np.abs(conf_all.numpy() - rconf_all).max() <= TOL
    wc = CFG.img_hw[1] // 8
    ri1 = (rxy1[:, 1].astype(int) // 2 - 2) // 4 * wc + (rxy1[:, 0].astype(int) // 2 - 2) // 4
    np.testing.assert_array_equal(top_i1.numpy(), ri1)
    np.testing.assert_array_equal(nn12[top_i1].numpy(), rnn12[ri1])
    xy1, xy2, conf, valid = (t.numpy() for t in m.run(img1, img2))
    assert int(rvalid.sum()) >= 10
    np.testing.assert_array_equal(valid, rvalid)
    np.testing.assert_array_equal(xy1, rxy1)
    assert np.abs(xy2 - rxy2)[rvalid].max() <= XY_TOL
    assert np.abs(conf - rconf).max() <= TOL


def _official_state_dict(port_net):
    """The port's weights under the official checkpoint's names."""
    sd = {f"matcher.{k}": v.clone() for k, v in port_net.state_dict().items()}
    sd["matcher.backbone.bn1.num_batches_tracked"] = torch.tensor(0)
    sd["matcher.pos_encoding.pe"] = torch.zeros(1, DIMS[2], 8, 12)
    return sd


def test_loftr_from_torch_round_trip(nets, tmp_path):
    jnet, variables, m = nets
    sd = _official_state_dict(m.net)
    path = str(tmp_path / "loftr.ckpt")
    torch.save({"state_dict": sd}, path)
    got = loftr.LoFTRMatcher(_port_cfg(CFG), checkpoint=path, device="cpu")
    assert got.trained
    with jax.enable_x64(False), compiled_flax_init():
        ref = jloftr.LoFTRMatcher(CFG)
    with jax.enable_x64(False):
        ref.params = jloftr.loftr_from_torch(
            {k: v for k, v in sd.items() if "pos_encoding" not in k and "num_batches" not in k},
            ref.params)
        r = ref.match_pair(*_pair())
    g = got.match_pair(*_pair())
    assert len(r[0]) >= 10
    np.testing.assert_array_equal(g[0], r[0])
    assert np.abs(g[1] - r[1]).max() <= XY_TOL and np.abs(g[2] - r[2]).max() <= TOL
    # same names, same function: loading the converted dict is exact
    for k, v in loftr_from_torch(sd).items():
        assert torch.equal(v, m.net.state_dict()[k])


def test_loftr_tracker_track_pair():
    """The LOFTR preset at its full width (dims 128/196/256, 4 coarse
    pairs, 8 heads) on a 64x96 input: the port's tracker with the JAX
    tracker's weights gives the same points; ``detectAndCompute`` raises
    in both."""
    from pyslam_tpu.features import tracker as jtracker
    from pyslam_tpu_torch.features import tracker

    extra = {"img_hw": (64, 96)}
    with jax.enable_x64(False), compiled_flax_init():
        jt = jtracker.feature_tracker_factory(dataclasses.replace(
            jtracker.FeatureTrackerConfigs.LOFTR, num_features=64, extra=extra))
    pt = tracker.feature_tracker_factory(dataclasses.replace(
        tracker.FeatureTrackerConfigs.LOFTR, num_features=64, extra=extra), device="cpu")
    assert type(pt).__name__ == "LoftrFeatureTracker" and not pt.trained
    pt.matcher.net.load_state_dict(interop.loftr_state_dict(flat_variables(jt.matcher.params)))
    jt.matcher.cfg.conf_threshold = pt.matcher.cfg.conf_threshold = 0.0
    img1, img2 = _pair()
    img1 = np.pad(img1, ((0, 8), (0, 16)), mode="edge")        # 72x112: rescaled to 64x96
    img2 = np.pad(img2, ((0, 8), (0, 16)), mode="edge")
    with jax.enable_x64(False):
        r = jt.track_pair(img1, img2)
    g = pt.track_pair(img1, img2)
    assert len(r[0]) >= 10
    np.testing.assert_array_equal(g[0], r[0])
    assert np.abs(g[1] - r[1]).max() <= XY_TOL * 112 / 96 and np.abs(g[2] - r[2]).max() <= TOL
    for t in (jt, pt):
        with pytest.raises(NotImplementedError):
            t.detectAndCompute(img1)
