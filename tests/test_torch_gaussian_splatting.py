"""Gaussian splatting in the port (pyslam_tpu_torch/ops/gaussian_splatting.py
and dense/gaussian_splatting_integrator.py) against the JAX package's,
the JAX package run with x64 off.

1. The JAX file's two rasterizer sanity tests (tests/test_gaussian_splatting.py),
   on the port.
2. 200 random gaussians at 64x64, k = 8 (and a case with ties: fewer valid
   gaussians than k, and pairs at the same place): colour, alpha and depth
   within ``TOL`` = 1e-5 of their largest magnitude, each tile's selected
   indices identical and in the same order (``jax.lax.top_k``'s order, then
   the stable depth sort); ``render_loss`` and its gradients within
   ``GRAD_TOL`` = 1e-4 of their largest magnitude (and a case with a tenth
   of them behind the camera, where the clamped depth overflows the 2D
   covariance: the gradients finite, and zero there as the reference's;
   a NaN there would make Adam drop those gaussians for the rest of a
   session); 3 ``optimize_gaussians``
   steps: the losses and every parameter within ``GRAD_TOL``.
3. The volume on two keyframes of the 64x96 RGBD line at capacity 512 (the
   first with depth on the left half only): the
   port's driven through ``VolumetricIntegrator`` (which calls it with its
   phases; the reference's integrator cannot drive the reference's volume,
   ROADMAP.md section 3), the JAX package's directly.  The second
   keyframe's seeds are thinned to the free slots in both; the Adam state
   (moments and step count) is carried through the insert into the same
   leaves.  Each keyframe from the same state (the reference's carried
   into the port after the first: the depth residuals at the seeds are
   zero up to rounding, see the test): the gaussians and the Adam state the
   optimisation starts from (the seeds, the coverage gate's choice, the
   thinning, the carried slots and moments) and its first loss within
   ``GRAD_TOL``; the saved ``.npz`` loads in either package and renders
   within ``TOL``.
4. ``Slam.load_system_state`` accepts a state saved with a Gaussian-
   splatting integrator attached.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.dense import gaussian_splatting_integrator as JGI
from pyslam_tpu.ops import gaussian_splatting as jgs
from pyslam_tpu_torch.dense import volumetric_integrator as TV
from pyslam_tpu_torch.dense.gaussian_splatting_integrator import GaussianSplattingVolume
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.ops import gaussian_splatting as gs
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from tests.torch_parity import rel_err, rng
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-5
GRAD_TOL = 1e-4
K64 = np.array([[60.0, 0, 32.0], [0, 60.0, 32.0], [0, 0, 1]], np.float32)


# ------------------------------------------------------------ 1. sanity
def _single_gaussian(xyz, color=1.0, scale=-2.0, cap=8):
    def arr(v, shape):
        return torch.full(shape, v, dtype=torch.float32)

    g = gs.Gaussians(means=arr(0.0, (cap, 3)), log_scales=arr(-10.0, (cap, 3)),
                     quats=torch.tensor([1.0, 0, 0, 0]).repeat(cap, 1),
                     opacity_logit=arr(-10.0, (cap,)), colors=arr(0.0, (cap, 1)),
                     valid=torch.zeros(cap, dtype=torch.bool))
    return _set(g, 0, xyz, color, scale)


def _set(g, i, xyz, color, scale):
    g.means[i] = torch.tensor(xyz)
    g.log_scales[i] = scale
    g.opacity_logit[i] = 4.0          # ~0.98
    g.colors[i] = color
    g.valid[i] = True
    return g


def test_rasterize_single_gaussian_center():
    g = _single_gaussian([0.0, 0.0, 2.0])
    color, acc, depth = gs.rasterize(g, torch.eye(4), torch.from_numpy(K64), 64, 64, k=8)
    color = color.numpy()[..., 0]
    cy, cx = np.unravel_index(np.argmax(color), color.shape)
    assert abs(cy - 32) <= 1 and abs(cx - 32) <= 1
    assert color[0, 0] < 0.01
    assert abs(float(depth[cy, cx]) / max(float(acc[cy, cx]), 1e-6) - 2.0) < 0.05


def test_rasterize_depth_ordering():
    """A nearer opaque gaussian occludes a farther one."""
    g = _set(_single_gaussian([0.0, 0.0, 2.0], color=1.0), 1, [0.0, 0.0, 4.0], 0.0, -1.0)
    color, _, _ = gs.rasterize(g, torch.eye(4), torch.from_numpy(K64), 64, 64, k=8)
    assert float(color[32, 32, 0]) > 0.8


# ------------------------------------------------------------ 2. parity
def _random_gaussians(seed, n=200, ties=False, behind=False):
    r = rng(seed)
    d = dict(means=np.c_[r.uniform(-1, 1, (n, 2)), r.uniform(1.5, 4, (n, 1))],
             log_scales=r.uniform(-3.0, -1.5, (n, 3)), quats=r.normal(size=(n, 4)),
             opacity_logit=r.normal(size=n), colors=r.uniform(0, 1, (n, 1)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["valid"] = r.uniform(size=n) < 0.9
    if behind:
        # a tenth of them behind the camera: z clamped to 1e-6, where the
        # 2D covariance overflows (the reference's gradient there is zero)
        d["means"][::10, 2] *= -1.0
    if ties:
        # six valid gaussians (every tile selects among -inf ties), two
        # pairs of them at the same place (equal scores and depths)
        d["valid"] = np.zeros(n, bool)
        d["valid"][[3, 17, 40, 41, 90, 150]] = True
        for a, b in ((40, 41), (90, 150)):
            for k in ("means", "log_scales", "quats"):
                d[k][b] = d[k][a]
    return d


def _both(d):
    return (jgs.Gaussians(**{k: jnp.asarray(v) for k, v in d.items()}),
            gs.Gaussians(**{k: torch.from_numpy(v.copy()) for k, v in d.items()}))


@functools.partial(jax.jit, static_argnames=("h", "w", "k"))
def _jax_tiles(g, Tcw, K, h, w, k):
    """Each tile's selection and depth order as the reference's
    ``rasterize`` computes them (``pyslam_tpu/ops/gaussian_splatting.py``),
    compiled as one graph as ``rasterize`` is."""
    mean2d, _, depth, radius, _, ok = jgs.project_gaussians(g, Tcw, K)
    ty = (jnp.arange(h // gs.TILE) + 0.5) * gs.TILE
    tx = (jnp.arange(w // gs.TILE) + 0.5) * gs.TILE
    cyx = jnp.stack(jnp.meshgrid(ty, tx, indexing="ij"), -1).reshape(-1, 2)
    dy = cyx[:, 0:1] - mean2d[None, :, 1]
    dx = cyx[:, 1:2] - mean2d[None, :, 0]
    margin = jnp.sqrt(dx * dx + dy * dy) - radius[None, :] - (gs.TILE * 0.7071)
    score = jnp.where(ok[None, :], -margin, -jnp.inf)
    _, idx = jax.lax.top_k(score, k)
    sel_ok = jnp.take_along_axis(score, idx, axis=1) > -1e30
    order = jnp.argsort(jnp.where(sel_ok, depth[idx], jnp.inf), axis=1)
    return jnp.take_along_axis(idx, order, 1), jnp.take_along_axis(sel_ok, order, 1)


TCW = np.eye(4, dtype=np.float32)
TCW[:3, 3] = [0.05, -0.02, 0.1]


@pytest.mark.parametrize("ties", [False, True])
def test_rasterize_against_jax(ties):
    jg, tg = _both(_random_gaussians(0, ties=ties))
    with jax.enable_x64(False):
        want = jgs.rasterize(jg, jnp.asarray(TCW), jnp.asarray(K64), 64, 64, 8)
        want_idx, want_ok = map(np.asarray, _jax_tiles(jg, jnp.asarray(TCW), jnp.asarray(K64),
                                                       64, 64, 8))
    *got, idx, sel_ok = gs.rasterize(tg, torch.from_numpy(TCW), torch.from_numpy(K64), 64, 64,
                                     8, return_indices=True)
    np.testing.assert_array_equal(sel_ok.numpy(), want_ok)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    for a, b in zip(got, want):
        assert a.shape == b.shape and rel_err(a, b) <= TOL
    if ties:
        assert (~want_ok).any() and want_ok.any()


def _targets(seed, b=1):
    r = rng(seed)
    return (r.uniform(0, 1, (b, 64, 64, 1)).astype(np.float32),
            r.uniform(1.0, 4.0, (b, 64, 64)).astype(np.float32))


def _check_render_loss_gradients(behind):
    d = _random_gaussians(1, behind=behind)
    jg, tg = _both(d)
    tgt, td = _targets(2)
    with jax.enable_x64(False):
        def loss(tr):
            return jgs.render_loss(jgs._combine(tr, {"valid": jg.valid}), jnp.asarray(TCW),
                                   jnp.asarray(K64), tgt[0], td[0], 64, 64, 8)

        want_l, want_g = jax.jit(jax.value_and_grad(loss))(jgs._trainable(jg))
    params = {k: v.requires_grad_(True) for k, v in gs.trainable(tg).items()}
    got_l = gs.render_loss(tg, torch.from_numpy(TCW), torch.from_numpy(K64),
                           torch.from_numpy(tgt[0]), torch.from_numpy(td[0]), 64, 64, 8)
    got_l.backward()
    assert abs(float(got_l.detach()) - float(want_l)) <= GRAD_TOL * abs(float(want_l))
    for k, p in params.items():
        assert float(np.abs(np.asarray(want_g[k])).max()) > 0, k
        assert torch.isfinite(p.grad).all(), k
        assert rel_err(p.grad, want_g[k]) <= GRAD_TOL, (k, rel_err(p.grad, want_g[k]))
    if behind:
        far = np.asarray(d["means"][:, 2] < 0)
        assert far.sum() == 20 and not np.asarray(want_g["means"])[far].any()


def test_render_loss_gradients():
    _check_render_loss_gradients(behind=False)


def test_render_loss_gradients_behind_the_camera():
    _check_render_loss_gradients(behind=True)


def test_optimize_three_steps():
    d = _random_gaussians(3)
    jg, tg = _both(d)
    tgt, td = _targets(4, b=2)
    Tcws = np.stack([TCW, TCW])
    Tcws[1, :3, 3] += [0.1, 0.0, 0.05]
    with jax.enable_x64(False):
        jo, jst, jl = jgs.optimize_gaussians(jg, None, jnp.asarray(Tcws), jnp.asarray(K64),
                                             jnp.asarray(tgt), jnp.asarray(td), 64, 64, 8, 3)
    to, tst, tl = gs.optimize_gaussians(tg, None, torch.from_numpy(Tcws), torch.from_numpy(K64),
                                        torch.from_numpy(tgt), torch.from_numpy(td), 64, 64, 8, 3)
    assert to.means is tg.means                       # updated in place
    assert tst.count == int(jst[0].count) == 3
    assert rel_err(tl, jl) <= GRAD_TOL
    for k in gs.TRAINABLE:
        assert rel_err(getattr(to, k), getattr(jo, k)) <= GRAD_TOL, k
        assert rel_err(tst.mu[k], jst[0].mu[k]) <= GRAD_TOL, k
        assert rel_err(tst.nu[k], jst[0].nu[k]) <= GRAD_TOL, k


# ------------------------------------------------------------ 3. the volume
class _KF:
    def __init__(self, kid, Twc):
        self.kid, self.Twc = kid, Twc


CAPACITY = 512
STRIDE = 2
STEPS = 2


@pytest.fixture(scope="module")
def volumes():
    ds = SyntheticDataset(num_frames=2, h=64, w=96, fx=60.0, sensor_type=SensorType.RGBD,
                          trajectory="line", step=0.3)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    integ = TV.volumetric_integrator_factory("gaussian_splatting", camera=cam,
                                             environment_type=ds.environment_type,
                                             device="cpu", capacity=CAPACITY,
                                             seed_stride=STRIDE, steps_per_kf=STEPS)
    ref = JGI.GaussianSplattingVolume(capacity=CAPACITY, seed_stride=STRIDE,
                                      depth_trunc=integ.volume.depth_trunc, steps_per_kf=STEPS)
    return ds, cam, integ, ref


def _host_state(st):
    """(count, mu, nu) of either package's Adam state, copied to the host."""
    if st is None:
        return None
    if isinstance(st, gs.AdamState):
        return (st.count, {k: v.clone().numpy() for k, v in st.mu.items()},
                {k: v.clone().numpy() for k, v in st.nu.items()})
    return int(st[0].count), {k: np.asarray(v) for k, v in st[0].mu.items()}, \
        {k: np.asarray(v) for k, v in st[0].nu.items()}


def _recorded(monkeypatch, mod, store):
    """Record the gaussians and the Adam state each optimisation starts from
    (copies), the state object itself, and the losses it returns."""
    orig = mod.optimize_gaussians

    def rec(g, opt_state, *args, **kw):
        store.append({"g": {k: np.array(v.detach() if isinstance(v, torch.Tensor) else v)
                            for k, v in g._asdict().items()},
                      "state": _host_state(opt_state), "state_obj": opt_state})
        out = orig(g, opt_state, *args, **kw)
        store[-1]["losses"] = np.asarray(out[2])
        return out

    monkeypatch.setattr(mod, "optimize_gaussians", rec)


def _integrate_both(ds, cam, integ, ref, i, half=False):
    """Keyframe ``i`` into both volumes; ``half``: its depth on the left
    half of the image only (the right half is seeded by a later one)."""
    depth = ds.getDepth(i).copy()
    if half:
        depth[:, depth.shape[1] // 2:] = 0.0
    with jax.enable_x64(False):
        ref.integrate(depth, ds.getImage(i), ds.poses[i], cam.K)
    integ.add_keyframe(_KF(i, ds.poses[i]), depth=depth, intensity=ds.getImage(i))
    steps = 0
    while integ.step():
        steps += 1
    assert steps == TV.VolumetricIntegrator._TSDF_PHASES     # the whole work at the last


def _same_params(got: dict, want: dict):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in gs.TRAINABLE:
        assert rel_err(got[k], want[k]) <= GRAD_TOL, (k, rel_err(got[k], want[k]))


def _same_state(got, want):
    assert got[0] == want[0]
    for k in gs.TRAINABLE:
        assert rel_err(got[1][k], want[1][k]) <= GRAD_TOL, k
        assert rel_err(got[2][k], want[2][k]) <= GRAD_TOL, k


def _carry_state(vol, ref):
    """The reference's gaussians and Adam state written into the port's
    leaves and state, in place."""
    with torch.no_grad():
        for k in gs.TRAINABLE:
            getattr(vol.g, k).copy_(torch.from_numpy(np.array(getattr(ref.g, k))))
            vol.opt_state.mu[k].copy_(torch.from_numpy(np.array(ref.opt_state[0].mu[k])))
            vol.opt_state.nu[k].copy_(torch.from_numpy(np.array(ref.opt_state[0].nu[k])))
    vol.opt_state.count = int(ref.opt_state[0].count)


def test_volume_two_keyframes(volumes, tmp_path, monkeypatch):
    ds, cam, integ, ref = volumes
    vol = integ.volume
    assert isinstance(vol, GaussianSplattingVolume) and vol.depth_trunc == 10.0
    jrec, trec = [], []
    _recorded(monkeypatch, jgs, jrec)
    _recorded(monkeypatch, gs, trec)
    _integrate_both(ds, cam, integ, ref, 0, half=True)
    assert vol.num_used == ref.num_used and vol.render_hw == ref.render_hw
    first = vol.num_used
    assert 0 < first < CAPACITY and vol.num_integrated == 1
    _same_params(trec[0]["g"], jrec[0]["g"])           # the first keyframe's seeds
    assert trec[0]["state"] is None and jrec[0]["state"] is None
    assert abs(trec[0]["losses"][0] - jrec[0]["losses"][0]) <= GRAD_TOL * jrec[0]["losses"][0]
    # From the first update on the two states part: the seeds sit on the
    # depth they were made from, so a seeded pixel's depth residual is zero
    # up to float32 rounding (54 and 59 exact zeros, 107 of the pixels of
    # opposite sign in the two packages), where the L1 gradient's sign is
    # the rounding's, and Adam scales the differing gradients to steps of up
    # to lr.  So each keyframe is held from the same state: the reference's
    # carried into the port's leaves.
    _carry_state(vol, ref)
    leaves = {k: getattr(vol.g, k) for k in gs.TRAINABLE}
    state = vol.opt_state

    _integrate_both(ds, cam, integ, ref, 1)
    # the second keyframe's seeds were more than the free slots: thinned
    assert vol.num_used == ref.num_used == CAPACITY
    assert trec[1]["g"]["valid"].sum() == CAPACITY
    # the insert wrote into the same leaves, and the Adam state carried on
    assert all(getattr(vol.g, k) is v for k, v in leaves.items())
    assert trec[1]["state_obj"] is state and vol.opt_state.count == 2 * STEPS
    # coverage gate, seeds, thinning and the carried slots and moments
    _same_params(trec[1]["g"], jrec[1]["g"])
    _same_state(trec[1]["state"], jrec[1]["state"])
    assert abs(trec[1]["losses"][0] - jrec[1]["losses"][0]) <= GRAD_TOL * jrec[1]["losses"][0]

    # save / load in either package
    Tcw = np.linalg.inv(ds.poses[1])
    color, acc, depth = vol.render(Tcw, cam.K)
    path = str(tmp_path / "gs.npz")
    integ.save(path)
    back = GaussianSplattingVolume(capacity=CAPACITY, device="cpu")
    back.load(path)
    assert back.num_used == CAPACITY and back.render_hw == vol.render_hw
    np.testing.assert_allclose(back.render(Tcw, cam.K)[0], color, atol=TOL)
    jback = JGI.GaussianSplattingVolume(capacity=CAPACITY)
    with jax.enable_x64(False):
        jback.load(path)
        for a, b in zip(jback.render(Tcw, cam.K), (color, acc, depth)):
            assert rel_err(a, b) <= TOL
        ref.save(str(tmp_path / "ref.npz"))
    back.load(str(tmp_path / "ref.npz"))
    with jax.enable_x64(False):
        want = ref.render(Tcw, cam.K)
    for a, b in zip(back.render(Tcw, cam.K), want):
        assert rel_err(a, b) <= TOL
    pts, cols = back.extract_point_cloud()
    want_pts, want_cols = ref.extract_point_cloud()
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_allclose(cols, want_cols, rtol=1e-6)
    integ.reset()
    assert vol.num_used == 0 and vol.opt_state is None and not vol.g.valid.any()


def test_phase_before_the_last_does_nothing():
    vol = GaussianSplattingVolume(capacity=64, device="cpu")
    depth = np.full((32, 48), 2.0, np.float32)
    vol.integrate(depth, depth * 50, np.eye(4), K64, phase=0, phases=3)
    assert vol.num_used == 0 and vol.num_integrated == 0 and vol.render_hw is None


# ---------------------------------------------------------- 4. the state
def test_slam_state_with_gaussian_splatting(tmp_path):
    ds = SyntheticDataset(num_frames=2, sensor_type=SensorType.RGBD, trajectory="line",
                          step=0.3)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=20.0)

    def session():
        slam = Slam(cam, FeatureTrackerConfig(num_features=300, num_levels=3),
                    sensor_type=SensorType.RGBD, device="cpu")
        slam.set_volumetric_integrator(TV.volumetric_integrator_factory(
            "gaussian_splatting", camera=cam, device="cpu", capacity=2048, steps_per_kf=2))
        return slam

    slam = session()
    for i in range(len(ds)):
        slam.track(ds.getImage(i), depth=ds.getDepth(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.finish()
    vol = slam.volumetric_integrator.volume
    assert vol.num_integrated >= 1 and vol.num_used > 0
    slam.save_system_state(str(tmp_path))
    again = session()
    again.load_system_state(str(tmp_path))
    got = again.volumetric_integrator.volume
    assert got.num_used == vol.num_used and got.device.type == "cpu"
    np.testing.assert_array_equal(got.g.means[:got.num_used].numpy(),
                                  vol.g.means[:vol.num_used].numpy())
