"""Checkpoint completeness in the port (the counterpart of
tests/test_checkpoint_complete.py): the loop-closing DB and the volumetric
state travel with the saved system state, and ``Slam.reset()`` clears
everything (the fast tests with a 1 << 18-slot voxel table).  The RGBD
loop stream (175 frames, period 160, 800 features on 4 levels, DBOW3) is
the reference test's; the session is saved at frame 100, reloaded into a
fresh ``Slam``, relocalises and closes the loop (slow, as the
reference's)."""

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu_torch.dense.volumetric_integrator import (
    VolumetricIntegratorType,
    volumetric_integrator_factory,
)
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from pyslam_tpu_torch.slam.tracking import TrackingState

TABLE = 1 << 18   # voxel-table slots of the fast tests (the CPU's time)


def _make(ds, n_feat=800):
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * 0.2,
                        depth_threshold=20.0)
    return Slam(cam, FeatureTrackerConfig(num_features=n_feat, num_levels=4),
                loop_detector_config="DBOW3", sensor_type=SensorType.RGBD, device="cpu")


def _line(n=10):
    return SyntheticDataset(num_frames=n, sensor_type=SensorType.RGBD, trajectory="line",
                            step=0.4)


def _integrate_all(slam, ds, integ):
    for i in range(len(ds)):
        img, depth = ds.getImage(i), ds.getDepth(i)
        slam.track(img, depth=depth, frame_id=i, timestamp=ds.getTimestamp(i))
        if slam.map.num_keyframes():
            integ.add_keyframe(slam.map.last_keyframe(),
                               depth=np.where(depth > 0, depth, 0.0), intensity=img)
            integ.run_all()
    slam.finish()


@pytest.mark.slow
def test_save_load_restores_loop_db_and_closes_loop(tmp_path):
    """save -> load -> relocalise -> close a loop, with the DB restored (the
    loaded session does not describe the old keyframes again)."""
    ds = SyntheticDataset(num_frames=175, sensor_type=SensorType.RGBD, trajectory="loop",
                          period=160)
    n_half = 100
    slam = _make(ds)
    for i in range(n_half):
        slam.track(ds.getImage(i), depth=ds.getDepth(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.finish()
    lc0 = slam.loop_closing
    assert len(lc0.db.kf_gdes) >= 5, "loop DB should hold described keyframes"
    p = str(tmp_path / "state")
    slam.save_system_state(p)

    slam2 = _make(ds)
    slam2.load_system_state(p)
    lc1 = slam2.loop_closing
    assert set(lc1.db.kf_gdes) == set(lc0.db.kf_gdes)
    for kid in lc0.db.kf_gdes:
        np.testing.assert_allclose(lc1.db.kf_gdes[kid], lc0.db.kf_gdes[kid], atol=1e-6)
        np.testing.assert_array_equal(lc1.db.kf_words[kid], lc0.db.kf_words[kid])
    assert lc1.db.inverted.keys() == lc0.db.inverted.keys()
    v0, v1 = lc0.detector.vocabulary, lc1.detector.vocabulary
    assert v1.checksum() == v0.checksum()
    np.testing.assert_array_equal(v1.centroids, v0.centroids)
    assert lc1.detector._trained

    assert slam2.state == TrackingState.INIT_RELOCALIZE
    for i in range(n_half, len(ds)):
        slam2.track(ds.getImage(i), depth=ds.getDepth(i), frame_id=i,
                    timestamp=ds.getTimestamp(i))
    slam2.finish()
    assert slam2.state == TrackingState.OK, "failed to relocalize+extend"
    assert slam2.loop_closing.num_loops_closed >= 1, "loop not closed after reload"


def test_reset_clears_loop_closing_and_volumetric():
    ds = _line()
    slam = _make(ds, n_feat=400)
    integ = volumetric_integrator_factory(VolumetricIntegratorType.TSDF, camera=slam.camera,
                                          capacity=TABLE, device="cpu")
    slam.set_volumetric_integrator(integ)
    _integrate_all(slam, ds, integ)
    assert len(slam.loop_closing.db.kf_gdes) > 0
    assert integ.volume.num_voxels() > 0

    slam.reset()
    assert len(slam.loop_closing.db.kf_gdes) == 0
    assert len(slam.loop_closing.db.inverted) == 0
    assert slam.loop_closing.consistency.prev_groups == []
    assert slam.loop_closing.num_loops_closed == 0
    assert integ.volume.num_voxels() == 0
    assert len(slam.local_mapping.queue) == 0
    assert slam.local_mapping._job is None and slam.local_mapping._lba is None


def test_volumetric_state_saved_with_system(tmp_path):
    ds = _line()
    slam = _make(ds, n_feat=400)
    integ = volumetric_integrator_factory(VolumetricIntegratorType.TSDF, camera=slam.camera,
                                          capacity=TABLE, device="cpu")
    slam.set_volumetric_integrator(integ)
    _integrate_all(slam, ds, integ)
    n_vox = integ.volume.num_voxels()
    assert n_vox > 0
    p = str(tmp_path / "state")
    slam.save_system_state(p)

    slam2 = _make(ds, n_feat=400)
    integ2 = volumetric_integrator_factory(VolumetricIntegratorType.TSDF, camera=slam2.camera,
                                           capacity=TABLE, device="cpu")
    slam2.set_volumetric_integrator(integ2)
    slam2.load_system_state(p)
    assert integ2.volume.num_voxels() == n_vox
    pts0, _ = integ.volume.extract_point_cloud()
    pts1, _ = integ2.volume.extract_point_cloud()
    np.testing.assert_allclose(np.sort(pts0, axis=0), np.sort(pts1, axis=0), atol=1e-9)
