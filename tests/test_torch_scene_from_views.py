"""scene_from_views in the port (pyslam_tpu_torch/scene_from_views/) and its
entry point against the JAX package, the JAX package run with x64 off.

1. GEOMETRIC on 3 views of the synthetic monocular line (every third
   frame, as ``main_scene_from_views``), the port given the reference's
   ORB2 features (the two extractions share 1497-1498 of their 1500
   keypoints as sets, but part at response near-ties at the slot cut and
   in slot order: ROADMAP.md section 3, so the port's own features are
   held as a set) and the reference's minimal samples
   (``tests.torch_parity.JaxKeySampler``, the split sequence of
   ``PRNGKey(3)``): the per-pair match counts and the RANSAC inlier masks
   identical and poses within ``POSE_TOL`` = 1e-4 of their largest
   magnitude (the float32 8-point refinement); given the reference's
   essential matrices, each pair's recovered pose within ``POSE_TOL`` and
   its in-front mask identical; given its poses too, the points within
   ``TRI_TOL`` = 1e-6 (float64 triangulation in both: the reference's request for
   float64 is truncated under x64 off, so its float64 host twin
   ``triangulate_dlt_np`` stands in).
2. DUST3R, MAST3R, MVDUST3R and DEPTH_ANYTHING_V3 through both factories
   on the same network outputs: the port's models at the tiny widths of
   tests/test_torch_dust3r_mast3r.py and tests/test_torch_depth_models.py
   (which hold them against the JAX package's), behind the reference's
   host interface in the reference's backends: poses and clouds within
   ``TOL`` = 1e-4 of their largest magnitude, the same number of points.
3. ``main_scene_from_views --device cpu --views 3`` writes an ``.npz`` that
   loads, with the run's poses and points; ``main_map_dense_reconstruction
   --device cpu --frames 4`` builds a map, replays its keyframes into the
   TSDF and saves a non-empty cloud (four frames: two keyframes to replay
   and 46237 cloud points, where the floor is 1000).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.models import depth_anything_v3 as jda3
from pyslam_tpu.models import dust3r as jdust3r
from pyslam_tpu.models import mast3r as jmast3r
from pyslam_tpu.models import mvdust3r as jmv
from pyslam_tpu.ops import epipolar as jepipolar
from pyslam_tpu.ops import geometry as jgeometry
from pyslam_tpu.scene_from_views import scene_from_views as jsfv
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu_torch import main_map_dense_reconstruction, main_scene_from_views
from pyslam_tpu_torch.features.orb2 import FeatureData
from pyslam_tpu_torch.models import depth_anything_v3, dust3r, mast3r, mvdust3r
from pyslam_tpu_torch.ops import epipolar
from pyslam_tpu_torch.scene_from_views import scene_from_views as tsfv
from pyslam_tpu_torch.slam.camera import PinholeCamera
from tests.test_torch_depth_models import DA3_SMALL, MV_SMALL
from tests.test_torch_dust3r_mast3r import D_TINY, M_TINY
from tests.torch_parity import JaxKeySampler, np_, rel_err, rng
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-4
POSE_TOL = 1e-4
# float64 DLT of the same inputs: the eigenvector of AᵀA squares the
# condition of a point near the epipole (6.5e-7 measured at 82 m)
TRI_TOL = 1e-6
VIEWS = 3


def _views():
    ds = JaxSyntheticDataset(num_frames=VIEWS * 3, sensor_type=JaxSensorType.MONOCULAR,
                             trajectory="line", step=0.5)
    return ds, [ds.getImage(i * 3) for i in range(VIEWS)]


def _recorded(monkeypatch, obj, name, store):
    orig = getattr(obj, name)

    def rec(*args, **kw):
        out = orig(*args, **kw)
        store.append(out)
        return out

    monkeypatch.setattr(obj, name, rec)


# ------------------------------------------------------------ 1. GEOMETRIC
def test_geometric(monkeypatch):
    ds, imgs = _views()
    jfeats, jess, jposes, tess = [], [], [], []
    with jax.enable_x64(False):
        ref = jsfv.scene_from_views_factory(
            "geometric", camera=JaxCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy))
        _recorded(monkeypatch, ref.tracker, "detectAndCompute", jfeats)
        _recorded(monkeypatch, jepipolar, "find_essential", jess)
        _recorded(monkeypatch, jepipolar, "recover_pose", jposes)
        # the reference asks for float64 triangulation, which x64 off
        # truncates to float32: its float64 host twin instead
        monkeypatch.setattr(jsfv, "geometry",
                            SimpleNamespace(triangulate_dlt=jgeometry.triangulate_dlt_np))
        want = ref.reconstruct(imgs)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    sv = tsfv.scene_from_views_factory("geometric", camera=cam, device="cpu",
                                       sampler=JaxKeySampler(3))
    own = [sv.tracker.detectAndCompute(im) for im in imgs]
    given = iter([FeatureData(*[torch.from_numpy(np.array(x)) for x in f]) for f in jfeats])
    monkeypatch.setattr(sv.tracker, "detectAndCompute", lambda img: next(given))
    _recorded(monkeypatch, epipolar, "find_essential", tess)
    got = sv.reconstruct(imgs)

    for fd, jfd in zip(own, jfeats):        # the port's own keypoints, as a set
        a = {tuple(r) for r in np.c_[np_(jfd.xy), np_(jfd.level)][np_(jfd.valid)].tolist()}
        b = {tuple(r) for r in np.c_[np_(fd.xy), np_(fd.level)][np_(fd.valid)].tolist()}
        assert len(a & b) >= 0.99 * len(a)
    assert got.per_view_matches == want.per_view_matches
    assert min(want.per_view_matches) >= 30
    assert sv.sampler.calls == len(jess) == len(tess) == VIEWS - 1
    for (_, m, n), (_, mr, nr) in zip(tess, jess):
        np.testing.assert_array_equal(np_(m), np_(mr))
        assert int(n) == int(nr)
    assert got.poses.shape == want.poses.shape == (VIEWS, 4, 4)
    assert rel_err(got.poses, want.poses) <= POSE_TOL
    assert got.points.shape == want.points.shape and len(got.points) > 0
    assert got.points.dtype == np.float64

    # given the reference's essential matrices the port's pose recovery
    # agrees; given its poses too, the same triangulation and depth gate (a
    # point near the epipole of this forward motion moves by centimetres
    # for a pose change of 1e-7)
    given = iter([FeatureData(*[torch.from_numpy(np.array(x)) for x in f]) for f in jfeats])
    ess, poses, own_poses = iter(jess), iter(jposes), []
    monkeypatch.setattr(epipolar, "find_essential", lambda *a, **k: tuple(
        torch.from_numpy(np.array(o)) for o in next(ess)))
    recover = epipolar.recover_pose

    def recover_given(*args):
        own_poses.append(recover(*args))
        return tuple(torch.from_numpy(np.array(o)) for o in next(poses))

    monkeypatch.setattr(epipolar, "recover_pose", recover_given)
    same = sv.reconstruct(imgs)
    for (T, front), (Tr, front_r) in zip(own_poses, jposes):
        np.testing.assert_array_equal(np_(front), np_(front_r))
        assert rel_err(T, Tr) <= POSE_TOL
    assert rel_err(same.poses, want.poses) <= 1e-12
    assert same.points.shape == want.points.shape
    assert rel_err(same.points, want.points) <= TRI_TOL


# ------------------------------------------------------- 2. network backends
class _HostPairs:
    """The port's two-view model behind the reference's ``infer_pair``
    (host arrays)."""

    def __init__(self, model):
        self.model = model

    def infer_pair(self, img1, img2):
        out = self.model.infer_pair(img1, img2)
        if isinstance(out[0], tuple):                   # MASt3R: one tuple a view
            return tuple(tuple(np_(o) for o in view) for view in out)
        return tuple(np_(o) for o in out)


@pytest.fixture(scope="module")
def nets():
    """The port's model of each backend at its tiny width (seeded weights)."""
    return {"dust3r": dust3r.Dust3rModel(dust3r.Dust3rConfig(**D_TINY), device="cpu"),
            "mast3r": mast3r.Mast3rModel(mast3r.Mast3rConfig(**M_TINY), device="cpu"),
            "mvdust3r": mvdust3r.MVDust3rModel(mvdust3r.MVDust3rConfig(**MV_SMALL),
                                               device="cpu"),
            "depth_anything_v3": depth_anything_v3.DepthAnything3(
                depth_anything_v3.DA3Config(**DA3_SMALL), device="cpu")}


# (backend, the class each package's backend builds, in its models module)
BACKENDS = (("dust3r", "Dust3rModel", jdust3r, dust3r),
            ("mast3r", "Mast3rModel", jmast3r, mast3r),
            ("mvdust3r", "MVDust3rModel", jmv, mvdust3r),
            ("depth_anything_v3", "DepthAnything3", jda3, depth_anything_v3))


@pytest.mark.parametrize("name,cls,jmod,tmod", BACKENDS, ids=[b[0] for b in BACKENDS])
def test_network_backends(nets, monkeypatch, name, cls, jmod, tmod):
    """Both packages' backends on the same network outputs: the port's model
    (held against the JAX package's at these widths by the model tests) in
    both, behind the reference's host interface in the reference's."""
    model = nets[name]
    host = _HostPairs(model) if name in ("dust3r", "mast3r") else model
    monkeypatch.setattr(jmod, cls, lambda checkpoint=None, **kw: host)
    monkeypatch.setattr(tmod, cls, lambda checkpoint=None, **kw: model)
    r = rng(7)
    imgs = [r.uniform(0, 255, (48, 64, 3)).astype(np.float32) for _ in range(VIEWS)]
    with jax.enable_x64(False):
        want = jsfv.scene_from_views_factory(name).reconstruct(imgs)
    sv = tsfv.scene_from_views_factory(name, device="cpu")
    assert sv.model is model and not model.trained
    res = sv.reconstruct(imgs)
    assert res.poses.shape == want.poses.shape == (VIEWS, 4, 4)
    assert np.isfinite(res.poses).all()
    assert rel_err(res.poses, want.poses) <= TOL
    assert res.points.shape == want.points.shape and len(res.points) > 0
    assert rel_err(res.points, want.points) <= TOL


# ------------------------------------------------------------ 3. the entry
def test_main_scene_from_views(tmp_path):
    path = str(tmp_path / "scene.npz")
    res = main_scene_from_views.run(["--device", "cpu", "--views", str(VIEWS), "--save", path])
    with np.load(path) as z:
        np.testing.assert_array_equal(z["poses"], res.poses)
        np.testing.assert_array_equal(z["points"], res.points)
    assert res.poses.shape == (VIEWS, 4, 4) and np.isfinite(res.poses).all()
    assert len(res.points) > 0 and len(res.per_view_matches) == VIEWS - 1


def test_main_map_dense_reconstruction(tmp_path):
    path = str(tmp_path / "cloud.npz")
    pts, cols = main_map_dense_reconstruction.run(["--device", "cpu", "--frames", "4",
                                                   "--save_cloud", path])
    assert len(pts) > 1000 and np.isfinite(pts).all() and cols.shape == pts.shape
    with np.load(path) as z:
        np.testing.assert_array_equal(z["points"], pts)
