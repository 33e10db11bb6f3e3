"""Projection search, epipolar triangulation matching and fuse candidates of
the port against ``pyslam_tpu.ops.slam_matching`` on a seeded map: the match
indices are discrete and must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.ops import lie as jlie
from pyslam_tpu.ops import slam_matching as jsm
from pyslam_tpu.ops.geometry import fundamental_np
from pyslam_tpu_torch.ops import slam_matching as tsm
from tests.torch_parity import f32, np_, rng, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]], np.float32)
IB = np.array([0, 320, 0, 240], np.float32)
SF = (1.2 ** np.arange(4)).astype(np.float32)
SIG2 = (SF ** 2).astype(np.float32)


def _map(seed, m=300, n=400):
    """Map points seen by a camera at the origin, and a frame whose
    keypoints are noisy projections of most of them plus clutter."""
    r = rng(seed)
    pts = np.concatenate([r.uniform(-6, 6, (m, 2)), r.uniform(4, 20, (m, 1))], 1)
    desc = r.integers(0, 2, (m, 256)).astype(np.int8)
    dist = np.linalg.norm(pts, axis=1)
    normal = (pts / dist[:, None]).astype(np.float32)
    level = r.integers(0, 4, m)
    max_d = (dist * SF[level]).astype(np.float32)
    min_d = (max_d / SF[-1]).astype(np.float32)
    pvalid = r.uniform(size=m) > 0.05
    T = np.asarray(jlie.se3_exp(jnp.asarray(np.r_[r.normal(size=3) * 0.05,
                                                  r.normal(size=3) * 0.01])))
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * K[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]
    seen = r.permutation(m)[: int(m * 0.8)]
    kps = np.concatenate([uv[seen] + r.normal(size=(len(seen), 2)) * 0.7,
                          r.uniform([0, 0], [320, 240], (n - len(seen), 2))]).astype(np.float32)
    kdesc = np.concatenate([desc[seen], r.integers(0, 2, (n - len(seen), 256))]).astype(np.int8)
    flips = r.uniform(size=kdesc.shape) < 0.06
    kdesc = np.where(flips, 1 - kdesc, kdesc).astype(np.int8)
    klevel = np.concatenate([level[seen], r.integers(0, 4, n - len(seen))])
    kvalid = r.uniform(size=n) > 0.03
    kur = np.where(r.uniform(size=n) > 0.5, kps[:, 0] - r.uniform(1, 20, n), -1.0)
    pt_side = [f32(pts), desc, normal, min_d, max_d, pvalid]
    kp_side = [kps, klevel, kdesc, kvalid, f32(kur)]
    return pt_side, kp_side, f32(T)


def _j(arrs):
    return [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in arrs]


def _t(arrs):
    return [torch.as_tensor(a) if a.dtype == np.int64 else t(a) for a in arrs]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("radius,ratio", [(7.0, 0.9), (3.0, 0.8)])
def test_search_by_projection(seed, radius, ratio):
    pt_side, kp_side, T = _map(seed)
    ref = jsm.search_by_projection(*_j(pt_side), *_j(kp_side), jnp.asarray(T), jnp.asarray(K),
                                   jnp.asarray(IB), jnp.asarray(SF), radius, 50.0, ratio=ratio)
    got = tsm.search_by_projection(*_t(pt_side), *_t(kp_side), t(T), t(K), t(IB), t(SF),
                                   radius, 50.0, ratio=ratio)
    for a, b in zip(ref, got):
        assert np.array_equal(np_(b), np.asarray(a))
    assert (np.asarray(ref[1]) >= 0).sum() > 50


@pytest.mark.parametrize("seed", [0, 1])
def test_epipolar_triangulation_match(seed):
    r = rng(seed + 10)
    pt_side, kp_side, T2 = _map(seed)
    kps1, lvl1, des1, val1, _ = kp_side
    # keyframe 2 sees the same points from a camera shifted sideways
    pts = pt_side[0]
    T2 = np.asarray(jlie.se3_exp(jnp.asarray([0.5, 0.0, 0.1, 0.0, 0.02, 0.0]))).astype(np.float32)
    pc = pts @ T2[:3, :3].T + T2[:3, 3]
    uv2 = (pc[:, :2] / pc[:, 2:] * K[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]).astype(np.float32)
    kps2 = np.concatenate([uv2, r.uniform([0, 0], [320, 240], (100, 2))]).astype(np.float32)
    des2 = np.concatenate([pt_side[1], r.integers(0, 2, (100, 256))]).astype(np.int8)
    lvl2 = r.integers(0, 4, len(kps2))
    free1 = val1 & (r.uniform(size=len(kps1)) > 0.2)
    free2 = r.uniform(size=len(kps2)) > 0.1
    T1 = np.eye(4)
    F = fundamental_np(T2 @ np.linalg.inv(T1), K, K).astype(np.float32)
    epi = np.array([1e6, 1e6], np.float32)
    ref, _ = jsm.epipolar_triangulation_match(
        *_j([kps1, lvl1, des1, free1, kps2, lvl2, des2, free2]), jnp.asarray(F),
        jnp.asarray(epi), jnp.asarray(SIG2), 100.0)
    got = tsm.epipolar_triangulation_match(
        *_t([kps1, lvl1, des1, free1]), *[x[None] for x in _t([kps2, lvl2, des2, free2])],
        t(F)[None], t(epi)[None], t(SIG2), 100.0)
    assert np.array_equal(np_(got[0]), np.asarray(ref))
    assert (np.asarray(ref) >= 0).sum() > 10


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuse_candidates(seed):
    pt_side, kp_side, T = _map(seed)
    ref_kp, ref_d = jsm.fuse_candidates(
        *_j(pt_side), *_j(kp_side), jnp.asarray(T), jnp.asarray(K), jnp.asarray(np.float32(40.0)),
        jnp.asarray(IB), jnp.asarray(SF), jnp.asarray(SIG2), 50.0)
    got_kp, got_d = tsm.fuse_candidates(
        *[x[None] for x in _t(pt_side)], *[x[None] for x in _t(kp_side)], t(T)[None], t(K),
        torch.tensor(40.0), t(IB), t(SF), t(SIG2), 50.0)
    assert np.array_equal(np_(got_kp[0]), np.asarray(ref_kp))
    ok = np.asarray(ref_kp) >= 0
    assert ok.sum() > 20
    assert np.array_equal(np_(got_d[0])[ok], np.asarray(ref_d)[ok])
