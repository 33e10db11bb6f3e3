"""Sim(3) of the port against the JAX package: the Lie-group maps, Umeyama,
the two Sim(3) RANSACs with the reference's own minimal samples injected,
the Sim(3) LM and the Sim(3) pose graph.  Every reference runs with x64 off,
as the JAX package runs outside the tests (the pose graph is handed float64
arrays there, which x64 off turns into float32).

Tolerances: the maps are held to 1e-5 absolute at |xi| <= 2 (float32, a few
ulps of the rotation and translation terms).  Umeyama, the RANSACs and the
LM rest on two different 3x3 SVD and solve implementations in float32: R, t
and s within 2e-4 (t in metres on a 20 m scene).  Inlier sets may differ by
at most 2 of the N correspondences: a point flips only when its error lies
within float32 rounding of the chi2 gate, and the data put none near it by
design, so 2 is a margin, not an expectation (the runs here differ by 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import np_, t

from pyslam_tpu.ops import epipolar as jepi
from pyslam_tpu.ops import lie as jlie
from pyslam_tpu.ops import optim as joptim
from pyslam_tpu.ops import procrustes as jproc
from pyslam_tpu_torch.ops import lie, optim, procrustes
from pyslam_tpu_torch.ops.epipolar import _sample_minimal, generator_sampler

K = np.array([[200.0, 0.0, 160.0], [0.0, 200.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
MAP_TOL = 1e-5
POSE_TOL = 2e-4
MARGIN = 2


def _xi(rng, n, scale):
    return (rng.normal(size=(n, 7)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-7, 1e-4, 0.3, 1.5])
def test_sim3_maps(scale):
    """exp, log, inv and W at small and large theta and sigma."""
    xi = _xi(np.random.default_rng(0), 16, scale)
    xi[0, 6] = 0.0      # sigma exactly 0: the small-sigma branch
    xi[1, 3:6] = 0.0    # theta exactly 0: the small-theta branch
    with jax.enable_x64(False):
        S_ref = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
        log_ref = np.asarray(jlie.sim3_log(jnp.asarray(S_ref)))
        inv_ref = np.asarray(jlie.sim3_inv(jnp.asarray(S_ref)))
        W_ref = np.asarray(jlie._sim3_W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6]),
                                        jnp.float32))
    S = np_(lie.sim3_exp(t(xi)))
    np.testing.assert_allclose(S, S_ref, atol=MAP_TOL * max(1.0, scale), rtol=0)
    np.testing.assert_allclose(np_(lie.sim3_log(t(S_ref))), log_ref, atol=MAP_TOL, rtol=1e-5)
    np.testing.assert_allclose(np_(lie.sim3_inv(t(S_ref))), inv_ref, atol=MAP_TOL * 10,
                               rtol=1e-5)
    # between the Taylor thresholds and |xi| ~ 1e-2 the closed-form
    # coefficients a and b cancel catastrophically in float32, in both
    # implementations; they multiply hat(w) and hat(w)^2, so W is held to
    # 2 |w| there (exp, which is what uses W, is held to 1e-5 above)
    w_tol = MAP_TOL + (2.0 * np.abs(xi[:, 3:6]).max() if 1e-6 < scale < 1e-2 else 0.0)
    np.testing.assert_allclose(np_(lie._sim3_W(t(xi[:, 3:6]), t(xi[:, 6]))), W_ref,
                               atol=w_tol, rtol=1e-5)


def test_forward_jacobian_at_zero():
    """The Jacobian of exp at xi = 0 goes through the Taylor branches, as
    the reference's jax.jacfwd does."""
    with jax.enable_x64(False):
        ref = np.asarray(jax.jacfwd(jlie.sim3_exp)(jnp.zeros(7, jnp.float32)))
    _, J = optim._jacobian7(lie.sim3_exp, (), torch.zeros(1))
    assert J.dtype == torch.float32
    np.testing.assert_allclose(np_(J), ref, atol=1e-7, rtol=0)


def _scene(rng, n=120, scale=1.3, n_out=20, noise_px=0.4):
    """Correspondences between two cameras: pts2 in camera 2, pts1 = S12
    pts2 in camera 1, pixel observations with noise, and n_out outliers."""
    pts2 = np.stack([rng.uniform(-6, 6, n), rng.uniform(-3, 3, n), rng.uniform(6, 20, n)], 1)
    S12 = np.asarray(jlie.sim3_exp(jnp.asarray(
        np.array([0.3, -0.1, 0.4, 0.02, 0.08, -0.03, np.log(scale)], np.float32))), np.float64)
    pts1 = pts2 @ S12[:3, :3].T + S12[:3, 3]

    def proj(p):
        return np.stack([K[0, 0] * p[:, 0] / p[:, 2] + K[0, 2],
                         K[1, 1] * p[:, 1] / p[:, 2] + K[1, 2]], 1)

    uv1 = proj(pts1) + rng.normal(0, noise_px, (n, 2))
    uv2 = proj(pts2) + rng.normal(0, noise_px, (n, 2))
    pts1 = pts1 * (1.0 + rng.normal(0, 0.003, (n, 1)))       # depth noise
    out = rng.choice(n, n_out, replace=False)
    pts2[out] = np.stack([rng.uniform(-6, 6, n_out), rng.uniform(-3, 3, n_out),
                          rng.uniform(6, 20, n_out)], 1)
    inlier = np.ones(n, bool)
    inlier[out] = False
    m = 128
    pad = lambda a, f=0.0: np.concatenate([a, np.full((m - n,) + a.shape[1:], f)])  # noqa: E731
    valid = np.arange(m) < n
    sig1 = np.where(rng.random(n) < 0.3, 1.44, 1.0)
    return dict(pts1=pad(pts1).astype(np.float32), pts2=pad(pts2).astype(np.float32),
                uv1=pad(uv1).astype(np.float32), uv2=pad(uv2).astype(np.float32),
                sig1=pad(sig1, 1.0).astype(np.float32), sig2=np.ones(m, np.float32),
                valid=valid, S12=S12.astype(np.float32), inlier=pad(inlier, False).astype(bool),
                w=pad(1.0 / np.maximum(pts1[:, 2], 0.5) ** 4, 0.0).astype(np.float32))


def _close_masks(a, b):
    assert abs(int(a.sum()) - int(b.sum())) <= MARGIN
    assert int((a != b).sum()) <= MARGIN


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama(with_scale):
    rng = np.random.default_rng(1)
    sc = _scene(rng, scale=1.3 if with_scale else 1.0, n_out=0)
    n = int(sc["valid"].sum())
    src, dst = sc["pts2"][:n], sc["pts1"][:n]
    w = rng.uniform(0.2, 1.0, n).astype(np.float32)
    for weights in (None, w):
        with jax.enable_x64(False):
            s_r, R_r, t_r = jproc.umeyama(jnp.asarray(src), jnp.asarray(dst),
                                          None if weights is None else jnp.asarray(weights),
                                          with_scale)
            S_r = np.asarray(jproc.umeyama_S(jnp.asarray(src), jnp.asarray(dst),
                                             None if weights is None else jnp.asarray(weights),
                                             with_scale))
        s, R, tt = procrustes.umeyama(t(src), t(dst), None if weights is None else t(weights),
                                      with_scale)
        np.testing.assert_allclose(float(s), float(s_r), atol=POSE_TOL)
        np.testing.assert_allclose(np_(R), np.asarray(R_r), atol=POSE_TOL)
        np.testing.assert_allclose(np_(tt), np.asarray(t_r), atol=POSE_TOL)
        np.testing.assert_allclose(np_(procrustes.umeyama_S(
            t(src), t(dst), None if weights is None else t(weights), with_scale)), S_r,
            atol=POSE_TOL)


def _ref_samples(key, valid, num_hyp, size, weights=None):
    with jax.enable_x64(False):
        return np.asarray(jepi._sample_minimal(
            key, jnp.asarray(valid), num_hyp, size,
            weights=None if weights is None else jnp.asarray(weights)))


@pytest.mark.parametrize("with_scale", [True, False])
def test_sim3_ransac_reproj_injected_samples(with_scale):
    sc = _scene(np.random.default_rng(2), scale=1.3 if with_scale else 1.0)
    key = jax.random.PRNGKey(11)
    num_hyp = 64
    samples = _ref_samples(key, sc["valid"], num_hyp, 3, sc["w"])
    args = [sc[k] for k in ("pts1", "pts2", "uv1", "uv2", "sig1", "sig2")]
    with jax.enable_x64(False):
        S_r, m_r, n_r = jproc.sim3_ransac_reproj(
            key, *map(jnp.asarray, args), jnp.asarray(sc["valid"]), jnp.asarray(K),
            jnp.asarray(K), num_hyp=num_hyp, with_scale=with_scale,
            sample_weights=jnp.asarray(sc["w"]))
        Ss_r = np.asarray(jax.vmap(lambda i: jproc.umeyama_S(
            jnp.asarray(sc["pts2"])[i], jnp.asarray(sc["pts1"])[i], with_scale=with_scale))(
            jnp.asarray(samples)))
    targs = [t(a) for a in args]
    S, m, n = procrustes.sim3_ransac_reproj(
        *targs, t(sc["valid"]), t(K), t(K), num_hyp=num_hyp, with_scale=with_scale,
        sample_weights=t(sc["w"]), samples=t(samples))
    # the same hypotheses win: per-hypothesis inlier counts of both
    # implementations' minimal solutions, scored by one error function
    Ss = procrustes.umeyama_S(t(sc["pts2"])[t(samples)], t(sc["pts1"])[t(samples)],
                              with_scale=with_scale)
    counts = [np_(((procrustes.mutual_reproj_err2(S_h, *targs[:4], *targs[4:], t(K), t(K))
                    < 9.21) & t(sc["valid"])).sum(1)) for S_h in (Ss, t(Ss_r))]
    assert np.abs(counts[0] - counts[1]).max() <= MARGIN
    assert int(np.argmax(counts[0])) == int(np.argmax(counts[1]))
    np.testing.assert_allclose(np_(Ss), Ss_r, atol=POSE_TOL * 5)
    np.testing.assert_allclose(np_(S), np.asarray(S_r), atol=POSE_TOL)
    _close_masks(np_(m), np.asarray(m_r))
    assert abs(int(n) - int(n_r)) <= MARGIN
    assert int(n) >= 90    # the 100 true correspondences, most of them kept


def test_sim3_ransac_injected_samples():
    sc = _scene(np.random.default_rng(3), scale=0.8)
    key = jax.random.PRNGKey(5)
    samples = _ref_samples(key, sc["valid"], 48, 3)
    th2 = 0.25
    with jax.enable_x64(False):
        S_r, m_r, n_r = jproc.sim3_ransac(key, jnp.asarray(sc["pts2"]), jnp.asarray(sc["pts1"]),
                                          jnp.asarray(sc["valid"]), th2, num_hyp=48)
    S, m, n = procrustes.sim3_ransac(t(sc["pts2"]), t(sc["pts1"]), t(sc["valid"]), th2,
                                     num_hyp=48, samples=t(samples))
    np.testing.assert_allclose(np_(S), np.asarray(S_r), atol=POSE_TOL)
    _close_masks(np_(m), np.asarray(m_r))
    assert abs(int(n) - int(n_r)) <= MARGIN and int(n) > 60


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3(fix_scale):
    sc = _scene(np.random.default_rng(4), scale=1.0 if fix_scale else 1.25)
    S0 = np.asarray(jlie.sim3_exp(jnp.asarray(
        np.array([0.05, 0.02, -0.04, 0.01, -0.005, 0.01, 0.0 if fix_scale else 0.03],
                 np.float32)))) @ sc["S12"]
    args = [sc[k] for k in ("pts1", "pts2", "uv1", "uv2", "sig1", "sig2")]
    init = sc["inlier"] | (np.arange(128) % 7 == 0)   # a few outliers in the seed set
    with jax.enable_x64(False):
        S_r, m_r, n_r = joptim.optimize_sim3(
            jnp.asarray(S0), *map(jnp.asarray, args), jnp.asarray(sc["valid"]),
            jnp.asarray(K), jnp.asarray(K), chi2_th=10.0, fix_scale=fix_scale,
            inliers_init=jnp.asarray(init))
    S, m, n = optim.optimize_sim3(t(S0), *map(t, args), t(sc["valid"]), t(K), t(K),
                                  chi2_th=10.0, fix_scale=fix_scale, inliers_init=t(init))
    np.testing.assert_allclose(np_(S), np.asarray(S_r), atol=POSE_TOL)
    _close_masks(np_(m), np.asarray(m_r))
    assert abs(int(n) - int(n_r)) <= MARGIN and int(n) >= 90
    # it converged to the truth, not merely to the reference
    np.testing.assert_allclose(np_(S), sc["S12"], atol=0.05)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_pose_graph_ring_with_loop_edge(fix_scale):
    """A ring of 10 vertices with odometry edges, one loop edge (9, 0) and
    two chords; vertex 0 fixed; the initial poses drifted."""
    rng = np.random.default_rng(5)
    V = 10
    xi_true = np.zeros((V, 7), np.float32)
    th = 2 * np.pi * np.arange(V) / V
    xi_true[:, 0] = 8.0 * np.sin(th)
    xi_true[:, 2] = 8.0 * (1 - np.cos(th))
    xi_true[:, 4] = th
    if not fix_scale:
        xi_true[:, 6] = rng.normal(0, 0.05, V)
    with jax.enable_x64(False):
        S_true = np.asarray(jlie.sim3_exp(jnp.asarray(xi_true)))
        drift = np.asarray(jlie.sim3_exp(jnp.asarray(
            (np.arange(V)[:, None] * np.array([[0.03, -0.02, 0.04, 0.004, 0.01, -0.006,
                                                0.0 if fix_scale else 0.01]])).astype(
                np.float32))))
    S_init = np.einsum("vij,vjk->vik", drift, S_true).astype(np.float32)
    edges = [(i, i + 1) for i in range(V - 1)] + [(0, V - 1), (2, 5), (4, 8)]
    ei = np.array([a for a, _ in edges], np.int32)
    ej = np.array([b for _, b in edges], np.int32)
    S_meas = np.stack([S_true[a] @ np.linalg.inv(S_true[b]) for a, b in edges])
    S_meas = S_meas @ np.asarray(jlie.sim3_exp(jnp.asarray(
        rng.normal(0, 0.002, (len(edges), 7)).astype(np.float32))))
    fixed = np.zeros(V, bool)
    fixed[0] = True
    with jax.enable_x64(False):
        ref = np.asarray(joptim.pose_graph_optimize(
            jnp.asarray(S_init, jnp.float64), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(S_meas, jnp.float64), jnp.ones(len(edges), bool), jnp.asarray(fixed),
            iters=10, fix_scale=fix_scale))
    assert ref.dtype == np.float32
    got = np_(optim.pose_graph_optimize(t(S_init), t(ei), t(ej), t(S_meas),
                                        torch.ones(len(edges), dtype=torch.bool), t(fixed),
                                        iters=10, fix_scale=fix_scale))
    np.testing.assert_allclose(got, ref, atol=POSE_TOL * 5)
    np.testing.assert_array_equal(got[0], S_init[0])
    # the drift was repaired
    err_init = np.abs(S_init[:, :3, 3] - S_true[:, :3, 3]).max()
    assert np.abs(got[:, :3, 3] - S_true[:, :3, 3]).max() < 0.2 * err_init


def test_sample_minimal_draws():
    """The port's own draws: valid rows only, no repeat within a hypothesis,
    the same draws for the same seed, and a weight that dominates is drawn
    in (almost) every hypothesis."""
    valid = torch.arange(64) < 40
    a = generator_sampler(torch.device("cpu"), 11)(valid, 300, 3)
    b = generator_sampler(torch.device("cpu"), 11)(valid, 300, 3)
    assert a.shape == (300, 3) and torch.equal(a, b)
    assert int(a.max()) < 40
    assert all(len(set(row.tolist())) == 3 for row in a)
    w = torch.ones(64)
    w[7] = 1e6
    s = _sample_minimal(valid, 300, 3, w, generator=torch.Generator().manual_seed(0))
    assert (s == 7).any(1).float().mean() > 0.95


def test_sim3_ransac_reproj_own_draws():
    """Without injected samples the RANSAC draws its own minimal sets and
    still finds the model."""
    sc = _scene(np.random.default_rng(6), scale=1.0)
    args = [t(sc[k]) for k in ("pts1", "pts2", "uv1", "uv2", "sig1", "sig2")]
    S, m, n = procrustes.sim3_ransac_reproj(
        *args, t(sc["valid"]), t(K), t(K), num_hyp=300, with_scale=False,
        sample_weights=t(sc["w"]), generator=torch.Generator().manual_seed(11))
    # the unrefined RANSAC model from noisy 3-D triples: within 0.2 m and
    # 0.02 of the rotation entries (the LM refines it on the pixels)
    np.testing.assert_allclose(np_(S)[:3, :3], sc["S12"][:3, :3], atol=0.02)
    np.testing.assert_allclose(np_(S)[:3, 3], sc["S12"][:3, 3], atol=0.2)
    assert int(n) >= 90 and int(np_(m)[~sc["inlier"]].sum()) <= MARGIN
