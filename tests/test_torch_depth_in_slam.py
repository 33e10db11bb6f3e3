"""The depth estimators in the port's SLAM loop: the mirror of
tests/test_depth_in_slam.py (the MONOCULAR -> RGBD upgrade by a depth
estimator, and the stereo TSDF fed by the integrator's SGM provider), the
integrator's host-depth branch, the prefetch rule, and the entry points
``main_slam --sensor mono --depth_estimator sgbm`` and
``main_depth_prediction`` on the CPU.

The 16-frame SGBM upgrade also runs through the JAX package's ``Slam`` (as
its own suite runs it, x64 on).  Held equal: the frames tracked (16/16)
and the sensor type (RGBD).  The keyframe count is held within one: the
JAX package's back-end readiness is its real asynchronous dispatch
(``jax.Array.is_ready``), so its keyframe cadence depends on how long each
frame took; with the SGM estimate in each frame it made keyframes at
frames 0, 3, 7, 10, 14 (5), without it (plain STEREO, x64 on) at 0, 3, 7,
12, as the port does in both (its readiness is a frame-count model,
``local_mapping.Pending``).  Both meet the reference test's floors (ATE is
not among them; the metric-scale floor is the trajectory length within 25
% of the ground truth's, with no alignment).

The host-depth branch: an estimator without a device path fills the same
voxel table in both packages' integrators, bit for bit, from the same
depth.
"""

import json

import jax
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)
from pyslam_tpu.dense import volumetric_integrator as JV
from pyslam_tpu.depth_estimation.depth_estimator import (DepthEstimatorType as JaxType,
                                                        depth_estimator_factory as jax_factory)
from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.slam import Slam as JaxSlam
from pyslam_tpu_torch import main_depth_prediction, main_slam
from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.dense import volumetric_integrator as TV
from pyslam_tpu_torch.depth_estimation.depth_estimator import (DepthEstimatorType,
                                                               depth_estimator_factory)
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam

N_FRAMES = 16
FIELDS = ("keys", "occupied", "tsdf", "weight", "color")


def _cam(cls, ds):
    return cls(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * ds.baseline,
               depth_threshold=20.0)


def _run(slam, ds):
    tracked = []
    for i in range(len(ds)):
        n = len(slam.tracking.history.timestamps)
        slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
        if len(slam.tracking.history.timestamps) > n:
            tracked.append(i)
    slam.finish()
    return tracked


@pytest.fixture(scope="module")
def upgraded():
    kw = dict(num_frames=N_FRAMES, trajectory="line", step=0.4)
    jds = JaxSyntheticDataset(sensor_type=JaxSensorType.STEREO, **kw)
    jcam = _cam(JaxCamera, jds)
    ref = JaxSlam(jcam, JaxTrackerConfig(num_features=500, num_levels=4),
                  sensor_type=JaxSensorType.MONOCULAR,
                  depth_estimator=jax_factory(JaxType.DEPTH_SGBM, camera=jcam, max_disparity=64))
    ref_tracked = _run(ref, jds)
    ds = SyntheticDataset(sensor_type=SensorType.STEREO, **kw)
    cam = _cam(PinholeCamera, ds)
    est = depth_estimator_factory(DepthEstimatorType.DEPTH_SGBM, camera=cam, max_disparity=64,
                                  device="cpu")
    slam = Slam(cam, FeatureTrackerConfig(num_features=500, num_levels=4),
                sensor_type=SensorType.MONOCULAR, depth_estimator=est, device="cpu")
    assert slam.sensor_type == SensorType.RGBD
    tracked = _run(slam, ds)
    return ref, ref_tracked, slam, tracked, ds


def test_depth_estimator_upgrades_mono_to_rgbd(upgraded):
    """The floors of tests/test_depth_in_slam.py's test of the same name."""
    _, _, slam, _, ds = upgraded
    assert slam.state.name == "OK"
    assert slam.map.num_points() > 100
    kf0 = slam.map.keyframes[slam.map.keyframe_order[0]]
    assert (kf0.depths > 0).sum() > 50, "estimated depth not attached"
    ts, poses = slam.get_final_trajectory()
    assert len(ts) >= len(ds) - 1
    gt = ds.poses[:, :3, 3]
    est_len = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1).sum()
    gt_len = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert abs(est_len - gt_len) / gt_len < 0.25, (est_len, gt_len)


def test_upgrade_tracks_as_the_reference(upgraded):
    ref, ref_tracked, slam, tracked, _ = upgraded
    assert ref.sensor_type.name == slam.sensor_type.name == "RGBD"
    assert tracked == ref_tracked == list(range(N_FRAMES))
    assert abs(slam.map.num_keyframes() - ref.map.num_keyframes()) <= 1, \
        (slam.map.num_keyframes(), ref.map.num_keyframes())


def test_stereo_tsdf_through_integrator_depth_provider():
    """The mirror of tests/test_depth_in_slam.py's test of the same name."""
    ds = SyntheticDataset(num_frames=12, sensor_type=SensorType.STEREO, trajectory="line",
                          step=0.4)
    cam = _cam(PinholeCamera, ds)
    slam = Slam(cam, FeatureTrackerConfig(num_features=500, num_levels=4),
                sensor_type=SensorType.STEREO, device="cpu")
    old = (Parameters.kVolumetricIntegrationUseDepthEstimator,
           Parameters.kVolumetricIntegrationDepthEstimatorType)
    Parameters.kVolumetricIntegrationUseDepthEstimator = True
    Parameters.kVolumetricIntegrationDepthEstimatorType = "sgbm"
    try:
        integ = TV.volumetric_integrator_factory(TV.VolumetricIntegratorType.TSDF, camera=cam,
                                                 voxel_size=0.3, sdf_trunc=0.9, device="cpu")
    finally:
        (Parameters.kVolumetricIntegrationUseDepthEstimator,
         Parameters.kVolumetricIntegrationDepthEstimatorType) = old
    assert integ._depth_provider is not None
    slam.set_volumetric_integrator(integ)
    _run(slam, ds)
    assert slam.map.num_keyframes() >= 1
    assert integ.volume.num_voxels() > 0
    snap = next(iter(integ.snapshots.values()))
    assert snap.depth is not None or (snap.intensity is not None and snap.img_right is not None)
    d_est, _ = integ._depth_provider.infer(snap.intensity, img_right=snap.img_right)
    assert np.isfinite(d_est[d_est > 0]).all()
    assert (d_est > 0).mean() > 0.1
    n_before = integ.volume.num_voxels()
    integ.volume.reset()
    assert integ.volume.num_voxels() == 0
    integ.rebuild(slam.map)
    assert integ.volume.num_voxels() > 0.5 * n_before


class _HostDepth:
    """An estimator with no device path: a fixed host depth (inf and nan
    where the integrator must drop it)."""

    device = torch.device("cpu")

    def __init__(self, depth):
        self.depth = depth
        self.calls = 0

    def infer(self, img, img_right=None):
        self.calls += 1
        return self.depth.copy(), None


class _KF:
    def __init__(self, kid, Twc):
        self.kid = self.id = kid
        self.Twc = Twc


def test_integrator_host_depth_branch():
    """A monocular estimator's host depth feeds the TSDF in both packages:
    the same table bit for bit after every step, non-finite depth dropped."""
    ds = SyntheticDataset(num_frames=5, sensor_type=SensorType.RGBD, trajectory="line", step=0.4)
    depth = np.asarray(ds.getDepth(0), np.float32).copy()
    depth[:5] = np.inf
    depth[5:9] = np.nan
    kw = (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    vol_kw = dict(voxel_size=0.2, sdf_trunc=0.6, capacity=1 << 16)
    outdoor = type("E", (), {"name": "OUTDOOR"})()
    ij = JV.volumetric_integrator_factory(JV.VolumetricIntegratorType.TSDF,
                                          camera=JaxCamera(*kw), environment_type=outdoor,
                                          **vol_kw)
    it = TV.volumetric_integrator_factory(TV.VolumetricIntegratorType.TSDF,
                                          camera=PinholeCamera(*kw), environment_type=outdoor,
                                          device="cpu", **vol_kw)
    providers = (_HostDepth(depth), _HostDepth(depth))
    for integ, p in zip((ij, it), providers):
        integ.set_depth_provider(p)
        for k in range(2):
            kf = _KF(k, ds.poses[4 * k])
            integ.offer_keyframe_data(kf, intensity=ds.getImage(4 * k))
            integ.add_keyframe(kf)
    for i in range(7):
        with jax.enable_x64(False):
            did_j = ij.step()
        assert it.step() == did_j
        for f in FIELDS:
            assert np.array_equal(getattr(it.volume.table, f).numpy(),
                                  np.asarray(getattr(ij.volume.table, f))), (i, f)
    assert providers[0].calls == providers[1].calls == 2
    assert it.volume.num_integrated == 2 and it.volume.num_voxels() > 1000
    snap = it.snapshots[0]
    assert isinstance(snap.depth, np.ndarray) and np.isfinite(snap.depth).all()


def test_prefetch_waits_for_an_estimate():
    """With a depth estimator the next frame is prefetched only when it
    needs no estimate (a right image or a depth of its own)."""
    ds = SyntheticDataset(num_frames=3, sensor_type=SensorType.RGBD, trajectory="line", step=0.4)
    cam = _cam(PinholeCamera, ds)
    est = _HostDepth(np.asarray(ds.getDepth(0), np.float32))
    slam = Slam(cam, FeatureTrackerConfig(num_features=300, num_levels=2),
                sensor_type=SensorType.MONOCULAR, depth_estimator=est, device="cpu")
    assert slam.sensor_type == SensorType.RGBD
    slam.track(ds.getImage(0), frame_id=0, timestamp=0.0,
               next_input={"img": ds.getImage(1), "frame_id": 1, "timestamp": 0.1})
    assert slam._prefetched is None and est.calls == 1
    slam.track(ds.getImage(1), frame_id=1, timestamp=0.1,
               next_input={"img": ds.getImage(2), "depth": ds.getDepth(2), "frame_id": 2,
                           "timestamp": 0.2})
    assert slam._prefetched is not None and slam._prefetched[0] == 2 and est.calls == 2
    with pytest.raises(ValueError):
        Slam(cam, FeatureTrackerConfig(num_features=300, num_levels=2),
             sensor_type=SensorType.MONOCULAR,
             depth_estimator=type("E", (), {"device": torch.device("meta")})(), device="cpu")


def test_main_slam_mono_with_sgbm(tmp_path, capsys):
    """``--sensor mono --depth_estimator sgbm``: the demo stream renders the
    right image for the estimator, the session runs as RGBD, and since the
    right image reaches the tracker too (as in the reference's
    ``Slam.track``) it tracks as the stereo session on the same frames."""
    metrics = {}
    for name, args in (("upgraded", ["--sensor", "mono", "--depth_estimator", "sgbm"]),
                       ("stereo", ["--sensor", "stereo"])):
        state = str(tmp_path / name)
        assert main_slam.main(args + ["--frames", "8", "--num_features", "400",
                                      "--no_loop_closing", "--device", "cpu",
                                      "--save_state", state]) == 0
        with open(f"{state}/other_metrics_info.txt") as f:
            metrics[name] = json.load(f)
        if name == "upgraded":
            assert "upgrading MONOCULAR to RGBD" in capsys.readouterr().out
    up, st = metrics["upgraded"], metrics["stereo"]
    assert up["num_frames"] == 8 and up["num_tracked"] >= 6
    for k in ("num_tracked", "num_lost", "num_keyframes", "num_points"):
        assert up[k] == st[k], (k, up, st)


def test_main_depth_prediction():
    rows = main_depth_prediction.run(["--estimator", "sgbm", "--frames", "2",
                                      "--device", "cpu"])
    assert len(rows) == 2
    for row in rows:
        assert row["coverage"] > 0.1 and row["median_rel_err"] < 0.15, row
