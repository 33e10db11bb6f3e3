"""Essential-matrix and homography RANSAC of the port against the JAX
package (``ops/epipolar.py``): the same seeded correspondences, pinned to
float32, with the reference's own minimal samples injected
(``_sample_minimal`` with its key; jitted and eager draws are identical),
the reference run with x64 off as it runs outside this suite.

Given the same model, every stage agrees to 1e-4:
``recover_pose`` of the reference's E gives the same pose (rotation <= 1e-4
rad, unit translation <= 1e-4) and the same in-front mask; the Sampson and
transfer errors of the same model give the same inlier masks except rows
within 1e-3 relative of the threshold.

End to end they agree only to the float32 conditioning of the reference's
solver: the minimal solvers take the null vector of a (9, 9) AᵀA formed in
float32, which squares the condition number of A.  Where the second
smallest eigenvalue of AᵀA is below 1e-5 of the largest (about 100 float32
epsilons; about 85 % of the hypotheses here) the null vector is
float32 noise in both packages, and their inlier counts for that hypothesis
differ by up to 182 of 300 rows.  So: on the hypotheses above that line
each package's float32 inlier count is held to the float64 count of the
same samples (``_eight_point`` on the float64 points), within 2 % of the
correspondences (measured 4 of 300 at most for the JAX package, 5 for the
port), and the port's mean deviation within 1 % (measured 0.59 at most).
The two float32 counts lie on either side of the float64 one, so their
difference is the sum of two such errors (9 of 300 on seed 1); end to end, over 8 seeds, the inlier counts within 10 % (measured 21
of 300), rotation within 2e-2 rad (measured 1.5e-2), the unit translation
within 0.15 (measured 0.117) and the median seed's rotation within 1e-3 rad
(measured 2.3e-4; 0 on 3 seeds).  An end-to-end 1e-4 is not met for
that reason."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import rng

from pyslam_tpu.ops import epipolar as jepi
from pyslam_tpu_torch.ops import epipolar
from pyslam_tpu_torch.utils.padding import pad_bucket, pad_rows
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

SEEDS = range(8)
F_PX = 500.0
TH_E = (1.0 / F_PX) ** 2 * 3.84


def _rot(v):
    th = np.linalg.norm(v)
    k = v / max(th, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _unit_dist(ta, tb):
    ta = np.asarray(ta, np.float64) / np.linalg.norm(ta)
    tb = np.asarray(tb, np.float64) / np.linalg.norm(tb)
    return float(np.linalg.norm(ta - tb))


def _two_view(seed, n=300, outliers=0.2, planar=False, truth=False):
    """Normalised correspondences of n points seen from two poses, 0.5 px
    of noise at f = 500, a share of gross outliers; padded to a bucket."""
    r = rng(seed)
    z = np.full(n, 10.0) if planar else r.uniform(4, 20, n)
    P = np.c_[r.uniform(-4, 4, n), r.uniform(-3, 3, n), z]
    R = _rot(r.normal(0, 0.05, 3))
    t = r.normal(0, 1, 3)
    t /= np.linalg.norm(t)
    x1 = P[:, :2] / P[:, 2:]
    Pc = P @ R.T + t
    x2 = Pc[:, :2] / Pc[:, 2:]
    x1 += r.normal(0, 0.5 / F_PX, x1.shape)
    x2 += r.normal(0, 0.5 / F_PX, x2.shape)
    bad = r.random(n) < outliers
    x2[bad] += r.normal(0, 0.05, (int(bad.sum()), 2))
    xy1, valid = pad_bucket(x1.astype(np.float32))
    xy2 = pad_rows(x2.astype(np.float32), len(valid))
    return (xy1, xy2, valid, R) if truth else (xy1, xy2, valid)


def _ref_essential(seed, xy1, xy2, valid):
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(seed)
        samples = np.asarray(jepi._sample_minimal(key, jnp.asarray(valid), 512, 8))
        E, mask, n = jepi.find_essential(key, jnp.asarray(xy1), jnp.asarray(xy2),
                                         jnp.asarray(valid), TH_E, 512)
        T, front = jepi.recover_pose(E, jnp.asarray(xy1), jnp.asarray(xy2), mask)
    return samples, np.asarray(E), np.asarray(mask), int(n), np.asarray(T), np.asarray(front)


def _near_threshold(err, th):
    return np.abs(err - th) <= 1e-3 * th


@pytest.mark.parametrize("seed", SEEDS)
def test_recover_pose_of_the_same_E(seed):
    xy1, xy2, valid = _two_view(seed)
    _, E, mask, _, T, front = _ref_essential(seed, xy1, xy2, valid)
    Tp, fp = epipolar.recover_pose(torch.from_numpy(E), torch.from_numpy(xy1),
                                   torch.from_numpy(xy2), torch.from_numpy(mask))
    Tp = Tp.numpy()
    assert _angle(Tp[:3, :3], T[:3, :3]) <= 1e-4
    assert _unit_dist(Tp[:3, 3], T[:3, 3]) <= 1e-4
    np.testing.assert_array_equal(fp.numpy(), front)


@pytest.mark.parametrize("seed", SEEDS)
def test_sampson_masks_of_the_same_E(seed):
    xy1, xy2, valid = _two_view(seed)
    _, E, _, _, _, _ = _ref_essential(seed, xy1, xy2, valid)
    with jax.enable_x64(False):
        ref = np.asarray(jepi._sampson_error(jnp.asarray(E), jnp.asarray(xy1), jnp.asarray(xy2)))
    got = epipolar._sampson_error(torch.from_numpy(E), torch.from_numpy(xy1),
                                  torch.from_numpy(xy2)).numpy()
    differ = ((got < TH_E) != (ref < TH_E)) & valid
    assert not (differ & ~_near_threshold(ref, TH_E)).any()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5 * TH_E)


def _well_conditioned(A: torch.Tensor) -> np.ndarray:
    """Hypotheses whose AᵀA (float64) keeps its null vector out of float32
    noise: second smallest eigenvalue above 1e-5 of the largest."""
    lam = torch.linalg.eigvalsh(A.transpose(-1, -2) @ A).numpy()
    return lam[:, 1] / lam[:, -1] > 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_essential_hypotheses_with_the_reference_samples(seed):
    xy1, xy2, valid = _two_view(seed)
    s = _ref_essential(seed, xy1, xy2, valid)[0]
    with jax.enable_x64(False):
        x1j, x2j = jnp.asarray(xy1), jnp.asarray(xy2)
        Es = jax.vmap(jepi._eight_point)(x1j[s], x2j[s])
        errs = jax.vmap(lambda E: jepi._sampson_error(E, x1j, x2j))(Es)
        ref = np.asarray(jnp.sum((errs < TH_E) & jnp.asarray(valid)[None], 1))
    st = torch.from_numpy(s.astype(np.int64))
    x1, x2 = torch.from_numpy(xy1), torch.from_numpy(xy2)
    Ep = epipolar._eight_point(x1[st], x2[st])
    got = torch.sum((epipolar._sampson_error(Ep, x1, x2) < TH_E) & torch.from_numpy(valid)[None],
                    1).numpy()
    x1d, x2d, vt = x1.double(), x2.double(), torch.from_numpy(valid)[None]
    E64 = epipolar._eight_point(x1d[st], x2d[st])
    exact = torch.sum((epipolar._sampson_error(E64, x1d, x2d) < TH_E) & vt, 1).numpy()
    good = _well_conditioned(epipolar._epipolar_rows(x1d[st], x2d[st]))
    assert good.sum() >= 30
    dev_ref, dev_port = np.abs(ref - exact)[good], np.abs(got - exact)[good]
    assert dev_ref.max() <= 0.02 * valid.sum(), (seed, dev_ref.max())
    assert dev_port.max() <= 0.02 * valid.sum(), (seed, dev_port.max())
    assert dev_port.mean() <= 0.01 * valid.sum(), (seed, dev_port.mean())


def test_find_essential_with_the_reference_samples():
    rows = []
    for seed in SEEDS:
        xy1, xy2, valid = _two_view(seed)
        samples, E, mask, n, T, _ = _ref_essential(seed, xy1, xy2, valid)
        x1, x2, v = torch.from_numpy(xy1), torch.from_numpy(xy2), torch.from_numpy(valid)
        Ep, mp, npt = epipolar.find_essential(x1, x2, v, TH_E, 512,
                                              samples=torch.from_numpy(samples.astype(np.int64)))
        Tp, _ = epipolar.recover_pose(Ep, x1, x2, mp)
        Tp = Tp.numpy()
        assert abs(int(npt) - n) <= 0.1 * valid.sum(), (seed, int(npt), n)
        assert int(npt) == int(mp.sum())
        rows.append((_angle(Tp[:3, :3], T[:3, :3]), _unit_dist(Tp[:3, 3], T[:3, 3])))
    rows = np.asarray(rows)
    assert rows[:, 0].max() <= 2e-2 and rows[:, 1].max() <= 0.15, rows
    assert np.median(rows[:, 0]) <= 1e-3, rows


def test_find_essential_draws_its_own_samples():
    """Without injected samples the port draws from its generator and
    recovers the pose as well as the reference does (rotation within 3e-2
    rad of the truth, as the reference's own draws on these seeds)."""
    for seed in (0, 1):
        xy1, xy2, valid, R_true = _two_view(seed, truth=True)
        gen = torch.Generator().manual_seed(3)
        x1, x2 = torch.from_numpy(xy1), torch.from_numpy(xy2)
        E, mask, n = epipolar.find_essential(x1, x2, torch.from_numpy(valid), TH_E, 512,
                                             generator=gen)
        T, _ = epipolar.recover_pose(E, x1, x2, mask)
        assert int(n) > 0.7 * valid.sum()
        assert _angle(T.numpy()[:3, :3], R_true) <= 3e-2


@pytest.mark.parametrize("seed", SEEDS)
def test_find_homography_with_the_reference_samples(seed):
    """Per hypothesis as the essential matrix (well-conditioned 4-point
    systems agree within 3 % of the rows: measured 7 of 300), and the chosen homography's
    inlier count within 10 %; the same model gives the same mask but near
    the threshold."""
    xy1, xy2, valid = _two_view(seed, planar=True)
    th = (2.0 / F_PX) ** 2
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(100 + seed)
        x1j, x2j = jnp.asarray(xy1), jnp.asarray(xy2)
        samples = np.asarray(jepi._sample_minimal(key, jnp.asarray(valid), 256, 4))
        H, mask, n = (np.asarray(x) for x in jepi.find_homography(
            key, x1j, x2j, jnp.asarray(valid), th, 256))
        err = np.asarray(jepi._h_transfer_error(jnp.asarray(H), x1j, x2j))
        Hs = jax.vmap(jepi._four_point_h)(x1j[samples], x2j[samples])
        ref_counts = np.asarray(jnp.sum(
            (jax.vmap(lambda h: jepi._h_transfer_error(h, x1j, x2j))(Hs) < th)
            & jnp.asarray(valid)[None], 1))
    st = torch.from_numpy(samples.astype(np.int64))
    x1, x2 = torch.from_numpy(xy1), torch.from_numpy(xy2)
    Hp, mp, npt = epipolar.find_homography(x1, x2, torch.from_numpy(valid), th, 256, samples=st)
    assert abs(int(npt) - int(n)) <= 0.1 * valid.sum()
    counts = torch.sum((epipolar._h_transfer_error(epipolar._four_point_h(x1[st], x2[st]), x1, x2)
                        < th) & torch.from_numpy(valid)[None], 1).numpy()
    xd, yd = x1.double()[st], x2.double()[st]
    z, o = torch.zeros_like(xd[..., 0]), torch.ones_like(xd[..., 0])
    r0 = torch.stack([-xd[..., 0], -xd[..., 1], -o, z, z, z, yd[..., 0] * xd[..., 0],
                      yd[..., 0] * xd[..., 1], yd[..., 0]], -1)
    r1 = torch.stack([z, z, z, -xd[..., 0], -xd[..., 1], -o, yd[..., 1] * xd[..., 0],
                      yd[..., 1] * xd[..., 1], yd[..., 1]], -1)
    good = _well_conditioned(torch.stack([r0, r1], -2).reshape(len(samples), 8, 9))
    assert good.sum() >= 10
    assert np.abs(counts - ref_counts)[good].max() <= 0.03 * valid.sum()
    ep = epipolar._h_transfer_error(torch.from_numpy(H), x1, x2).numpy()
    differ = ((ep < th) != (err < th)) & valid
    assert not (differ & ~_near_threshold(err, th)).any()
