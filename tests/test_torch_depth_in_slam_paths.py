"""The port's depth paths besides the SGBM upgrade (split from
tests/test_torch_depth_in_slam.py, whose docstring describes them, so
that the xdist workers share its time): the stereo TSDF fed by the
integrator's SGM provider, the integrator's host-depth branch against the
JAX package's, the prefetch rule, and the entry points."""

import json

import jax
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)
from pyslam_tpu.dense import volumetric_integrator as JV
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu_torch import main_depth_prediction, main_slam
from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.dense import volumetric_integrator as TV
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from tests.test_torch_depth_in_slam import _cam, _run
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

FIELDS = ("keys", "occupied", "tsdf", "weight", "color")


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
