"""The dense slice as a whole on the CPU.

1. The volumetric integrator's schedule, port against reference: both
   integrators, built by their factories as ``bench.py`` builds them (SGM
   depth provider at downscale 2, TSDF, OUTDOOR truncation), take the same
   3 keyframes of the 240x320 synthetic stereo stream with ground-truth
   poses and are stepped in turns.  After every ``step()`` the two volumes
   are compared key by key: every slot's key and ``occupied`` identical,
   and ``tsdf``/``weight``/``color`` bit for bit (the SGM depth and the
   updates are identical on the CPU, see test_torch_sgm.py and
   test_torch_tsdf.py); ``rebuild`` too.
2. The port's stereo ``Slam`` with the integrator attached, on the stream
   of tests/test_depth_in_slam.py (12 frames, 500 features on 4 levels,
   voxel 0.3 m): that test's floors (voxels > 0, a sane re-estimated depth,
   ``rebuild`` repopulates > 50 % of the volume), and every keyframe handed
   over with images integrated in all 3 phases.
"""

import jax
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)
from pyslam_tpu.config_parameters import Parameters as JaxParameters
from pyslam_tpu.dense import volumetric_integrator as JV
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.dense import volumetric_integrator as TV
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam

FIELDS = ("keys", "occupied", "tsdf", "weight", "color")
_FLAGS = ("kVolumetricIntegrationUseDepthEstimator", "kVolumetricIntegrationDepthEstimatorType")


class _KF:
    def __init__(self, kid, Twc):
        self.kid = kid
        self.id = kid
        self.Twc = Twc


class _Map:
    def __init__(self, kfs):
        self.keyframe_order = [kf.kid for kf in kfs]
        self.keyframes = {kf.kid: kf for kf in kfs}


def _factory(module, params, cam, **kw):
    """An integrator with the SGM depth provider, built by ``module``'s
    factory with ``params`` switched as bench.py switches them."""
    old = [getattr(params, f) for f in _FLAGS]
    params.kVolumetricIntegrationUseDepthEstimator = True
    params.kVolumetricIntegrationDepthEstimatorType = "sgbm"
    try:
        return module.volumetric_integrator_factory(
            module.VolumetricIntegratorType.TSDF, camera=cam,
            environment_type=type("E", (), {"name": "OUTDOOR"})(), **kw)
    finally:
        for f, v in zip(_FLAGS, old):
            setattr(params, f, v)


def _assert_same_volume(vj, vt, where):
    for f in FIELDS:
        a, b = np.asarray(getattr(vj.table, f)), getattr(vt.table, f).numpy()
        assert np.array_equal(b, a), f"{where}: {f}"


@pytest.fixture(scope="module")
def stepped():
    ds = SyntheticDataset(num_frames=9, sensor_type=SensorType.STEREO, trajectory="line",
                          step=0.4)
    kw = (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    bf = ds.fx * ds.baseline
    vol_kw = dict(voxel_size=0.2, sdf_trunc=0.6, capacity=1 << 17)
    ij = _factory(JV, JaxParameters, JaxCamera(*kw, bf=bf), **vol_kw)
    it = _factory(TV, Parameters, PinholeCamera(*kw, bf=bf), device="cpu", **vol_kw)
    kfs = [_KF(k, ds.poses[4 * k]) for k in range(3)]
    log = []

    def offer(kf):
        imgs = (ds.getImage(4 * kf.kid), ds.getImageRight(4 * kf.kid))
        for integ in (ij, it):
            integ.offer_keyframe_data(kf, intensity=imgs[0], img_right=imgs[1])
            integ.add_keyframe(kf)

    offer(kfs[0])
    offer(kfs[1])
    for i in range(12):
        if i == 2:
            offer(kfs[2])     # a keyframe arrives while another is in flight
        with jax.enable_x64(False):
            did_j = ij.step()
        did_t = it.step()
        log.append((did_j, did_t, ij.volume.num_voxels(), it.volume.num_voxels(),
                    ij._staged is None, it._staged is None))
        _assert_same_volume(ij.volume, it.volume, f"after step {i}")
    return ij, it, kfs, log


def test_step_schedule_matches_reference(stepped):
    ij, it, _, log = stepped
    for did_j, did_t, nj, nt, sj, st in log:
        assert (did_j, nj, sj) == (did_t, nt, st)
    # 3 keyframes x (1 SGM stage + 3 TSDF phases), then idle
    assert [d for d, *_ in log] == [True] * 12
    assert not it.step() and not it.queue and it._staged is None
    assert it.volume.num_integrated == ij.volume.num_integrated == 3
    assert it.volume.num_voxels() > 1000
    # the estimated depth is dropped after the last phase of each keyframe
    assert all(s.depth is None for s in it.snapshots.values())


def test_rebuild_matches_reference(stepped):
    ij, it, kfs, _ = stepped
    n = it.volume.num_voxels()
    with jax.enable_x64(False):
        ij.rebuild(_Map(kfs))
    it.rebuild(_Map(kfs))
    _assert_same_volume(ij.volume, it.volume, "rebuild")
    assert abs(it.volume.num_voxels() - n) < 0.2 * n


def test_integrator_refuses_another_device():
    cam = PinholeCamera(64, 48, 50, 50, 32, 24, bf=5.0)
    vol = TV.TSDFVolume(capacity=1 << 8, device="cpu")
    with pytest.raises(ValueError):
        TV.VolumetricIntegrator(cam, volume=vol, device="meta")
    with pytest.raises(NotImplementedError, match="item 4.1"):
        TV.volumetric_integrator_factory("gaussian_splatting", camera=cam, device="cpu")
    from pyslam_tpu_torch.dense.semantic_volume import SemanticTSDFVolume

    for kind in ("voxel_semantic_grid", "voxel_semantic_probabilistic_grid"):
        integ = TV.volumetric_integrator_factory(kind, camera=cam, device="cpu",
                                                 capacity=1 << 8)
        assert isinstance(integ.volume, SemanticTSDFVolume)
        assert integ.volume.class_scores.shape == (1 << 8, 21)
    slam = Slam(cam, FeatureTrackerConfig(num_features=100, num_levels=2),
                sensor_type=SensorType.STEREO, device="cpu")
    meta = TV.VolumetricIntegrator(cam, volume=TV.TSDFVolume(capacity=1 << 8, device="meta"),
                                   device="meta")
    with pytest.raises(ValueError):
        slam.set_volumetric_integrator(meta)


@pytest.fixture(scope="module")
def slam_run():
    ds = SyntheticDataset(num_frames=12, sensor_type=SensorType.STEREO, trajectory="line",
                          step=0.4)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=500, num_levels=4),
                sensor_type=SensorType.STEREO, device="cpu")
    old = [getattr(Parameters, f) for f in _FLAGS]
    Parameters.kVolumetricIntegrationUseDepthEstimator = True
    Parameters.kVolumetricIntegrationDepthEstimatorType = "sgbm"
    try:
        integ = TV.volumetric_integrator_factory(TV.VolumetricIntegratorType.TSDF, camera=cam,
                                                 voxel_size=0.3, sdf_trunc=0.9, device="cpu")
    finally:
        for f, v in zip(_FLAGS, old):
            setattr(Parameters, f, v)
    assert integ._depth_provider is not None
    slam.set_volumetric_integrator(integ)
    for i in range(len(ds)):
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.finish()
    return slam, integ


def test_slam_fills_the_volume(slam_run):
    slam, integ = slam_run
    assert slam.map.num_keyframes() >= 1
    assert integ.volume.num_voxels() > 0
    # every keyframe handed over with its images was integrated, all phases
    assert len(integ.snapshots) >= 1
    assert integ.volume.num_integrated == len(integ.snapshots)
    assert integ._staged is None and not integ.queue
    st = slam.timings()["volumetric_integrator"]
    assert st["sgm"]["calls"] == len(integ.snapshots)
    assert st["tsdf"]["calls"] == 3 * len(integ.snapshots)
    assert integ.volume.table.tsdf.device.type == "cpu"


def test_reestimated_depth_and_rebuild(slam_run):
    slam, integ = slam_run
    snap = next(iter(integ.snapshots.values()))
    assert snap.depth is None and snap.intensity is not None and snap.img_right is not None
    d_est, _ = integ._depth_provider.infer(snap.intensity, img_right=snap.img_right)
    assert np.isfinite(d_est[d_est > 0]).all()
    assert (d_est > 0).mean() > 0.1
    n_before = integ.volume.num_voxels()
    integ.volume.reset()
    assert integ.volume.num_voxels() == 0
    integ.rebuild(slam.map)
    assert integ.volume.num_voxels() > 0.5 * n_before


def test_reset_clears_the_integrator(slam_run):
    slam, integ = slam_run
    slam.reset()
    assert integ.volume.num_voxels() == 0 and not integ.snapshots and slam._last_input is None
    assert isinstance(integ.volume.table.keys, torch.Tensor)
