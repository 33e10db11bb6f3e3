"""Pose optimisation and bundle adjustment of the port against
``pyslam_tpu.ops.optim`` on the same seeded problems (float32 on both
sides).  Tolerances: poses within 1e-4 (rotation entries and translation in
metres) and points within 1e-3 relative — float32 LM in two frameworks with
different summation orders; inlier masks are discrete and identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.ops import lie as jlie
from pyslam_tpu.ops import optim as joptim
from pyslam_tpu_torch.ops import lie as tlie
from pyslam_tpu_torch.ops import optim as toptim
from tests.torch_parity import f32, np_, rng, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
BF = 500.0 * 0.12


def _se3(xi):
    return np.asarray(jlie.se3_exp(jnp.asarray(np.asarray(xi, np.float64))))


def _scene(seed, n_cams, n_pts=150):
    r = rng(seed)
    pts = np.concatenate([r.uniform(-4, 4, (n_pts, 2)), r.uniform(6.0, 14.0, (n_pts, 1))], 1)
    poses = np.stack([_se3(np.concatenate([[0.4 * i, 0, 0] + r.normal(size=3) * 0.05,
                                           r.normal(size=3) * 0.03]))
                      for i in range(n_cams)])
    cam, pt, uv, ur = [], [], [], []
    for c in range(n_cams):
        pc = pts @ poses[c][:3, :3].T + poses[c][:3, 3]
        u = 500.0 * pc[:, 0] / pc[:, 2] + 320.0
        v = 500.0 * pc[:, 1] / pc[:, 2] + 240.0
        for p in range(n_pts):
            if 0 < u[p] < 640 and 0 < v[p] < 480:
                cam.append(c)
                pt.append(p)
                uv.append([u[p], v[p]])
                ur.append(u[p] - BF / pc[p, 2] if p % 2 == 0 else -1.0)
    uv = np.asarray(uv) + r.normal(size=(len(uv), 2)) * 0.5
    out = r.choice(len(uv), len(uv) // 8, replace=False)
    uv[out] += r.uniform(20, 60, (len(out), 2))
    return poses, pts, np.asarray(cam), np.asarray(pt), uv, np.asarray(ur), r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_optimization(seed):
    poses, pts, cam, pt, uv, ur, r = _scene(seed, n_cams=1)
    T0 = _se3(np.concatenate([r.normal(size=3) * 0.05, r.normal(size=3) * 0.02])) @ poses[0]
    n = len(pt)
    sigma2 = r.choice([1.0, 1.44, 2.0736], n)
    valid = r.uniform(size=n) > 0.05
    args = [T0, pts[pt], uv, ur, sigma2]
    Tj, inl_j, n_j = joptim.pose_optimization(
        *[jnp.asarray(f32(a)) for a in args], jnp.asarray(valid), jnp.asarray(K), bf=BF)
    Tt, inl_t, n_t = toptim.pose_optimization(
        *[t(a) for a in args], t(valid), t(K), bf=BF)
    np.testing.assert_allclose(np_(Tt), np.asarray(Tj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np_(Tt), poses[0], rtol=0, atol=2e-2)
    assert np.array_equal(np_(inl_t), np.asarray(inl_j))
    assert int(n_t) == int(n_j)


def _problems(seed):
    poses, pts, cam, pt, uv, ur, r = _scene(seed, n_cams=5)
    noisy = np.stack([_se3(np.concatenate([r.normal(size=3) * 0.02, r.normal(size=3) * 0.005]))
                      @ p for p in poses])
    noisy[0] = poses[0]
    pts_n = pts + r.normal(size=pts.shape) * 0.05
    o = len(cam)
    fixed = np.zeros(5, bool)
    fixed[0] = True
    fields = dict(poses=noisy, points=pts_n, cam_idx=cam, pt_idx=pt, uv=uv, ur=ur,
                  sigma2=r.choice([1.0, 1.44], o), valid=r.uniform(size=o) > 0.02,
                  fixed=fixed, K=K, bf=np.float32(BF))
    jp = joptim.BAProblem(**{k: jnp.asarray(v.astype(np.int32) if k in ("cam_idx", "pt_idx")
                                            else (f32(v) if np.asarray(v).dtype.kind == "f"
                                                  else v))
                             for k, v in fields.items()})
    tp = toptim.BAProblem(**{k: (torch.as_tensor(v) if k in ("cam_idx", "pt_idx")
                                 else t(v)) for k, v in fields.items()})
    return jp, tp


def _close(got, ref):
    pj, xj = np.asarray(ref[0]), np.asarray(ref[1])
    np.testing.assert_allclose(np_(got[0]), pj, rtol=0, atol=1e-4)
    scale = np.maximum(np.abs(xj), 1.0)
    assert np.max(np.abs(np_(got[1]) - xj) / scale) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjust_chunked_resume(seed):
    jp, tp = _problems(seed)
    rj = joptim.bundle_adjust(jp, iters=3, return_state=True)
    rt = toptim.bundle_adjust(tp, iters=3, return_state=True)
    _close(rt, rj)
    assert np.array_equal(np_(rt[4]), np.asarray(rj[4]))
    np.testing.assert_allclose(float(rt[3]), float(rj[3]), rtol=1e-6)
    rj2 = joptim.bundle_adjust(jp._replace(poses=rj[0], points=rj[1]), iters=3, lam0=rj[3],
                               return_state=True)
    rt2 = toptim.bundle_adjust(tp._replace(poses=rt[0], points=rt[1]), iters=3, lam0=rt[3],
                               return_state=True)
    _close(rt2, rj2)
    assert np.array_equal(np_(rt2[4]), np.asarray(rj2[4]))
    # the fixed camera does not move
    assert np.array_equal(np_(rt2[0])[0], np_(tp.poses)[0])
    np.testing.assert_allclose(float(rt2[2]), float(rj2[2]), rtol=1e-3)


def test_bundle_adjust_reduces_cost():
    _, tp = _problems(2)
    cost0, _, _ = toptim.ba_cost_and_chi2(tp)
    _, _, cost = toptim.bundle_adjust(tp, iters=6)
    assert float(cost) < float(cost0)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_exp_log(seed):
    xi = rng(seed).normal(size=(8, 6)) * 0.5
    ref = np.asarray(jlie.se3_exp(jnp.asarray(f32(xi))))
    got = np_(tlie.se3_exp(t(xi)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    back = np_(tlie.se3_log(t(got)))
    np.testing.assert_allclose(back, np.asarray(jlie.se3_log(jnp.asarray(ref))), rtol=0,
                               atol=1e-5)
