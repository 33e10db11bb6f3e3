"""The port's TSDF volume against ``pyslam_tpu.dense.tsdf`` on the same numpy
inputs, the reference with x64 off as the JAX package runs.

What must be equal, and the tolerance of the rest:
- ``depth_to_voxel_updates`` in every phase of a 3-phase split and
  unsplit, at strides 1-3: coordinates, sdf, weights, colors and the valid
  mask bit for bit (tolerance 0).  The world point is rounded as XLA's CPU
  code rounds it, ``fma(z, r2, fma(y, r1, x * r0)) + t``: at a voxel of
  3e-7 m, where ``floor`` resolves the last bits, that order leaves 0 of
  8000 coordinates different, while the plain order moves 3615 of them;
- ``TSDFVolume.integrate``: every slot's key and ``occupied`` identical,
  and ``tsdf``/``weight``/``color`` bit for bit on the CPU;
- the spatial queries and carving: the masks and counts of the reference,
  and the reference's own checks (tests/test_tsdf_spatial.py);
- ``extract_mesh``: the same vertices and faces;
- a volume saved by the JAX package loads into the port with every slot
  in place, and further integration stays identical.
"""

from copy import deepcopy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)
from pyslam_tpu.dense import tsdf as J
from pyslam_tpu_torch.dense import tsdf as T
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

FIELDS = ("keys", "occupied", "tsdf", "weight", "color")


def _inputs(seed=1, h=120, w=160):
    r = np.random.default_rng(seed)
    depth = r.uniform(1, 20, (h, w)).astype(np.float32)
    depth[r.random((h, w)) < 0.1] = 0.0
    inten = r.uniform(0, 255, (h, w)).astype(np.float32)
    Twc = np.eye(4)
    Twc[:3, :3] = Rotation.from_rotvec(r.normal(size=3) * 0.5).as_matrix()
    Twc[:3, 3] = r.normal(size=3) * 3
    K = np.array([[100.3, 0, 80.2], [0, 101.1, 60.7], [0, 0, 1]], np.float32)
    return depth, inten, Twc.astype(np.float32), K


CASES = [(vs, stride, phase, phases) for vs in (0.2, 3e-7) for stride, phase, phases in
         ((1, 0, 1), (2, 0, 3), (2, 1, 3), (2, 2, 3), (3, 0, 1), (3, 2, 3))]


@pytest.mark.parametrize("vs,stride,phase,phases", CASES)
def test_depth_to_voxel_updates_bit_equal(vs, stride, phase, phases):
    depth, inten, Twc, K = _inputs()
    with jax.enable_x64(False):
        ref = J.depth_to_voxel_updates(jnp.asarray(depth), jnp.asarray(inten), jnp.asarray(Twc),
                                       jnp.asarray(K), vs, 0.6, 15.0, stride, 2, phase, phases)
    got = T.depth_to_voxel_updates(torch.from_numpy(depth), torch.from_numpy(inten),
                                   torch.from_numpy(Twc), torch.from_numpy(K), vs, 0.6, 15.0,
                                   stride, 2, phase, phases)
    for name, a, b in zip(("coords", "sdf", "w", "color", "valid"), ref, got):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype, name
        assert np.array_equal(b.numpy(), a), name
    assert np.asarray(ref[4]).any()


def test_plain_order_moves_coordinates():
    """Why the world point is summed as XLA rounds it: at a 3e-7 m voxel the
    plain order ``(x*r0 + y*r1) + z*r2 + t`` puts 3615 of the 8000
    coordinates of phase 1 of 3 (stride 2) in another voxel than the
    reference (measured; asserted as more than a quarter), the pinned
    order none."""
    depth, inten, Twc, K = _inputs()
    vs = 3e-7
    with jax.enable_x64(False):
        ref = np.asarray(J.depth_to_voxel_updates(
            jnp.asarray(depth), jnp.asarray(inten), jnp.asarray(Twc), jnp.asarray(K), vs, 0.6,
            15.0, 2, 2, 1, 3)[0])
    got = T.depth_to_voxel_updates(torch.from_numpy(depth), torch.from_numpy(inten),
                                   torch.from_numpy(Twc), torch.from_numpy(K), vs, 0.6, 15.0,
                                   2, 2, 1, 3)[0]
    assert np.array_equal(got.numpy(), ref)
    # the same rays and samples, summed in the plain order
    H, W = depth.shape
    ys = np.minimum((1 + 3 * np.arange(20)) * 2, H - 1)     # 20 = ceil(ceil(H/2)/3)
    gy, gx = np.meshgrid(ys, np.arange(0, W, 2), indexing="ij")
    gy, gx = torch.from_numpy(gy.reshape(-1)), torch.from_numpy(gx.reshape(-1))
    Kt, Tt = torch.from_numpy(K), torch.from_numpy(Twc)
    d = torch.from_numpy(depth)[gy, gx]
    rx = (gx.float() - Kt[0, 2]) / Kt[0, 0]
    ry = (gy.float() - Kt[1, 2]) / Kt[1, 1]
    dz = d[:, None] + (torch.arange(5, dtype=torch.float32) - 2) * vs
    px, py = rx[:, None] * dz, ry[:, None] * dz
    pw = torch.stack([(px * Tt[i, 0] + py * Tt[i, 1]) + dz * Tt[i, 2] + Tt[i, 3]
                      for i in range(3)], -1)
    plain = torch.floor(pw / torch.tensor(vs, dtype=torch.float32)).to(torch.int32).reshape(-1, 3)
    moved = int((plain.numpy() != ref).any(1).sum())
    assert len(ref) == 8000 and moved > 2000, moved


def _integrate_both(vol_kw, views, hw=None):
    vj = J.TSDFVolume(**vol_kw)
    vt = T.TSDFVolume(**vol_kw, device="cpu")
    for depth, inten, Twc, K, phase, phases in views:
        with jax.enable_x64(False):
            vj.integrate(depth, inten, Twc, K, phase=phase, phases=phases)
        vt.integrate(depth, inten, Twc, K, phase=phase, phases=phases)
    return vj, vt


def _assert_tables_equal(vj, vt):
    for f in FIELDS:
        a, b = np.asarray(getattr(vj.table, f)), getattr(vt.table, f).numpy()
        assert np.array_equal(b, a), f


def test_integrate_matches_reference_table():
    depth, inten, Twc, K = _inputs(2)
    depth2, inten2, _, _ = _inputs(3)
    Twc2 = Twc.copy()
    Twc2[:3, 3] += 0.3
    views = [(depth, inten, Twc, K, p, 3) for p in range(3)]
    views += [(depth2, inten2, Twc2, K, 0, 1)]
    vj, vt = _integrate_both(dict(voxel_size=0.2, sdf_trunc=0.6, depth_trunc=15.0,
                                  capacity=1 << 16), views)
    _assert_tables_equal(vj, vt)
    assert vt.num_voxels() == vj.num_voxels() > 1000
    assert vt.stride == vj.stride and vt.band_steps == vj.band_steps
    assert vt.num_integrated == vj.num_integrated == 2


@pytest.fixture(scope="module")
def walls():
    """The volume of tests/test_tsdf_spatial.py (a wall at z = 2 m seen from
    the origin) in both packages."""
    H, W = 60, 80
    K = np.array([[60.0, 0, 40], [0, 60.0, 30], [0, 0, 1]], np.float32)
    depth = np.full((H, W), 2.0, np.float32)
    inten = np.full((H, W), 128.0, np.float32)
    vj, vt = _integrate_both(dict(voxel_size=0.05, sdf_trunc=0.15, depth_trunc=5.0,
                                  capacity=1 << 15),
                             [(depth, inten, np.eye(4, dtype=np.float32), K, 0, 1)])
    return vj, vt, K, (H, W)


def test_bbox_and_frustum_masks(walls):
    vj, vt, K, hw = walls
    _assert_tables_equal(vj, vt)
    n = vt.num_voxels()
    assert n > 100
    for lo, hi in (([-5, -5, 1.7], [5, 5, 2.3]), ([-5, -5, 4.0], [5, 5, 5.0]),
                   ([-0.5, -0.5, 0.0], [0.5, 0.5, 5.0])):
        assert np.array_equal(vt.voxels_in_bbox(lo, hi), vj.voxels_in_bbox(lo, hi))
    assert vt.voxels_in_bbox([-5, -5, 1.7], [5, 5, 2.3]).sum() > 0.9 * n
    assert vt.voxels_in_bbox([-5, -5, 4.0], [5, 5, 5.0]).sum() == 0
    away = np.eye(4)
    away[:3, :3] = np.diag([1.0, -1.0, -1.0])
    for T_ in (np.eye(4), away):
        assert np.array_equal(vt.voxels_in_frustum(T_, K, hw), vj.voxels_in_frustum(T_, K, hw))
    assert vt.voxels_in_frustum(np.eye(4), K, hw).sum() > 0.9 * n
    assert vt.voxels_in_frustum(away, K, hw).sum() == 0


def test_carving_and_crop(walls):
    vj0, vt0, K, (H, W) = walls
    vj, vt = deepcopy(vj0), deepcopy(vt0)
    n0 = vt.num_voxels()
    far = np.full((H, W), 3.0, np.float32)
    carved = vt.carve(far, np.eye(4), K)
    assert carved == vj.carve(far, np.eye(4), K) > 0.8 * n0
    assert vt.num_voxels() < 0.2 * n0
    _assert_tables_equal(vj, vt)

    vj, vt = deepcopy(vj0), deepcopy(vt0)
    vt.crop_bbox([-0.5, -0.5, 0.0], [0.5, 0.5, 5.0])
    vj.crop_bbox([-0.5, -0.5, 0.0], [0.5, 0.5, 5.0])
    _assert_tables_equal(vj, vt)
    assert 0 < vt.num_voxels() < n0
    pts, _ = vt.extract_point_cloud()
    assert (np.abs(pts[:, :2]) <= 0.55).all()
    pj, cj = vj.extract_point_cloud()
    assert np.array_equal(pts, pj)


def test_carve_then_reintegrate_fresh_state(walls):
    """Carving zeroes the freed slots, so a new surface does not inherit
    their weights (the reference's regression check), identically."""
    vj0, vt0, K, (H, W) = walls
    vj, vt = deepcopy(vj0), deepcopy(vt0)
    inten = np.full((H, W), 128.0, np.float32)
    views = [(np.full((H, W), 2.0, np.float32), inten, np.eye(4, dtype=np.float32), K)] * 5
    for v in views:
        with jax.enable_x64(False):
            vj.integrate(*v)
        vt.integrate(*v)
    far = np.full((H, W), 3.0, np.float32)
    assert vt.carve(far, np.eye(4), K) == vj.carve(far, np.eye(4), K) > 0
    occ = vt.table.occupied.numpy()
    assert np.all(vt.table.weight.numpy()[~occ] == 0.0)
    assert np.all(vt.table.tsdf.numpy()[~occ] == 0.0)
    new = (np.full((H, W), 2.5, np.float32), inten, np.eye(4, dtype=np.float32), K)
    with jax.enable_x64(False):
        vj.integrate(*new)
    vt.integrate(*new)
    _assert_tables_equal(vj, vt)
    pts, _ = vt.extract_point_cloud(min_weight=0.5)
    assert len(pts) > 0
    assert (np.abs(pts[:, 2] - 2.5) < 0.25).sum() > 0.9 * len(pts)


def test_extract_mesh_equals_reference():
    h, w = 64, 80
    K = np.array([[70.0, 0, 40.0], [0, 70.0, 32.0], [0, 0, 1]], np.float32)
    depth = np.full((h, w), 2.0, np.float32)
    gray = np.full((h, w), 128.0, np.float32)
    vj, vt = _integrate_both(dict(voxel_size=0.05, sdf_trunc=0.15, capacity=1 << 18),
                             [(depth, gray, np.eye(4), K, 0, 1)] * 3)
    verts, faces, cols = vt.extract_mesh()
    rv, rf, rc = vj.extract_mesh()
    assert np.array_equal(verts, rv) and np.array_equal(faces, rf) and np.array_equal(cols, rc)
    assert len(verts) > 100 and len(faces) > 100
    assert np.abs(verts[:, 2] - 2.0).max() < 0.08


def test_save_and_load_npz_round_trip(tmp_path):
    """A volume the JAX package saved loads into the port slot for slot;
    both then integrate one more view identically, and the port's own save
    reads back into the reference."""
    depth, inten, Twc, K = _inputs(4, 60, 80)
    kw = dict(voxel_size=0.2, sdf_trunc=0.6, depth_trunc=15.0, capacity=1 << 14)
    vj, _ = _integrate_both(kw, [(depth, inten, Twc, K, 0, 1)])
    vj.save(str(tmp_path / "jax.npz"))
    vt = T.TSDFVolume(**kw, device="cpu")
    vt.load(str(tmp_path / "jax.npz"))
    _assert_tables_equal(vj, vt)
    depth2, inten2, _, _ = _inputs(5, 60, 80)
    with jax.enable_x64(False):
        vj.integrate(depth2, inten2, Twc, K)
    vt.integrate(depth2, inten2, Twc, K)
    _assert_tables_equal(vj, vt)
    vt.save(str(tmp_path / "torch.npz"))
    back = J.TSDFVolume(**kw)
    back.load(str(tmp_path / "torch.npz"))
    _assert_tables_equal(back, vt)


def test_flat_wall_reconstruction():
    """The reference's flat-wall checks (tests/test_tsdf.py) on the port."""
    vol = T.TSDFVolume(voxel_size=0.05, sdf_trunc=0.2, depth_trunc=5.0, capacity=1 << 16,
                       device="cpu")
    H, W = 120, 160
    K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]])
    depth = np.full((H, W), 2.0, np.float32)
    img = np.full((H, W), 128.0, np.float32)
    vol.integrate(depth, img, np.eye(4), K)
    n1 = vol.num_voxels()
    assert n1 > 500
    pts, _ = vol.extract_point_cloud(tsdf_band=0.3, min_weight=0.5)
    assert len(pts) > 200
    assert abs(np.median(pts[:, 2]) - 2.0) < 0.1
    assert np.percentile(np.abs(pts[:, 2] - 2.0), 90) < 0.16
    Twc = np.eye(4)
    Twc[0, 3] = 0.1
    vol.integrate(depth, img, Twc, K)
    assert vol.num_voxels() < n1 * 1.5


def test_volume_refuses_a_tensor_on_another_device():
    vol = T.TSDFVolume(voxel_size=0.2, capacity=1 << 8, device="meta")
    with pytest.raises(ValueError):
        vol.integrate(torch.zeros(4, 4), np.zeros((4, 4)), np.eye(4), np.eye(3))
