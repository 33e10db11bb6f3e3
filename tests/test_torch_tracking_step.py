"""One tracking step of the port against the JAX package from the same
state: the JAX ``Slam`` tracks 8 frames of the 240x320 stereo stream, its
map is carried across with ``interop.map_from_tpu_json`` (with the last
frame's pose and assignments, the motion model and the descriptor gate),
and both packages track frame 9: once from the same features (the JAX
frame's, handed to the port), once with the port's own extraction.

Tolerances: from the same features, poses within 1e-3 m / 1e-3 rad (float32
LM in two frameworks) and >= 98 % of the matched map-point ids identical;
with the port's own extraction see ``test_own_features``."""

import jax
import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.frame import Frame as JaxFrame
from pyslam_tpu.slam.map_serialization import map_to_json
from pyslam_tpu.slam.slam import Slam as JaxSlam
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.interop import map_from_tpu_json
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.frame import Frame
from pyslam_tpu_torch.slam.slam import Slam
from pyslam_tpu_torch.slam.tracking import TrackingState
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

N = 8


def _cam(cls, ds):
    return cls(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * ds.baseline,
               depth_threshold=20.0)


def _port_from(js, d, cam):
    """A port Slam in the JAX session's state: its map (carried across as
    the JSON dict ``d``), reference keyframe, previous frame, motion model
    and descriptor gate."""
    jt = js.tracking
    ts = Slam(cam, FeatureTrackerConfig(num_features=600, num_levels=4),
              sensor_type=SensorType.STEREO, device="cpu")
    ts.map = map_from_tpu_json(d, cam, ts.feature_tracker)
    tt = ts.tracking
    tt.map = ts.local_mapping.map = ts.map
    tt.state = TrackingState.OK
    tt.kf_ref = ts.map.keyframes[jt.kf_ref.kid]
    tt.last_kf_frame_id = jt.last_kf_frame_id
    tt.num_inliers = jt.num_inliers
    tt.dyn_config.descriptor_distance_th = jt.dyn_config.descriptor_distance_th
    mm, jm = tt.motion_model, jt.motion_model
    mm.is_ok, mm._last_Tcw, mm._velocity = jm.is_ok, jm._last_Tcw.copy(), jm._velocity.copy()
    tt.f_prev = _port_frame(jt.f_prev, cam, ts.feature_tracker)
    return ts


def _port_frame(jfr, cam, tracker):
    """A port Frame holding a JAX frame's features, pose and assignment."""
    f = Frame(cam, feature_tracker=tracker, frame_id=jfr.id, timestamp=jfr.timestamp)
    f.set_host_fields(kps=jfr.kps.copy(), levels=jfr.levels.copy(), angles=jfr.angles.copy(),
                      sizes=jfr.sizes.copy(), valid=jfr.valid.copy(), kps_ur=jfr.kps_ur.copy(),
                      depths=jfr.depths.copy())
    f.des = np.asarray(jfr.des)
    f.points = jfr.points.copy()
    f.outliers = jfr.outliers.copy()
    f.update_pose(jfr.Tcw)
    return f


@pytest.fixture(scope="module")
def both():
    with jax.enable_x64(False):
        return _both()


def _both():
    """Both packages from the same JAX session state (the JAX package with
    x64 off, as it runs outside this suite)."""
    ds = JaxSyntheticDataset(num_frames=N + 1, sensor_type=JaxSensorType.STEREO,
                             trajectory="line", step=0.4)
    frames = [(ds.getImage(i).astype(np.float32), ds.getImageRight(i).astype(np.float32),
               ds.getTimestamp(i)) for i in range(N + 1)]
    jcam = _cam(JaxCamera, ds)
    js = JaxSlam(jcam, JaxTrackerConfig(num_features=600, num_levels=4),
                 sensor_type=JaxSensorType.STEREO)
    for i in range(N):
        js.track(frames[i][0], img_right=frames[i][1], frame_id=i, timestamp=frames[i][2])
    js.local_mapping.finish()
    assert js.tracking.state.name == "OK"
    cam = _cam(PinholeCamera, ds)
    d = map_to_json(js.map)
    ts_own = _port_from(js, d, cam)      # tracks the frame it extracts itself
    ts_same = _port_from(js, d, cam)     # tracks the JAX frame's features

    img_l, img_r, stamp = frames[N]
    jfr = JaxFrame(jcam, img_l, img_right=img_r, timestamp=stamp,
                   feature_tracker=js.feature_tracker, frame_id=N)
    same_in = _port_frame(jfr, cam, ts_same.feature_tracker)
    jf = js.tracking.track(img_l, img_right=img_r, frame_id=N, timestamp=stamp, frame=jfr)
    tf_same = ts_same.tracking.track(None, frame_id=N, timestamp=stamp, frame=same_in)
    tf_own = ts_own.tracking.track(img_l, img_right=img_r, frame_id=N, timestamp=stamp)
    return js, (ts_same, tf_same), (ts_own, tf_own), jf, ds


def test_both_track_ok(both):
    js, (ts, tf), (ts2, tf2), _, _ = both
    assert js.tracking.state.name == "OK"
    assert ts.tracking.state == TrackingState.OK and ts2.tracking.state == TrackingState.OK
    assert (tf.points >= 0).sum() > 100


def test_map_carried_across(both):
    js, (ts, _), _, _, _ = both
    assert ts.map.num_points() >= js.map.num_points() - 1
    assert set(js.map.keyframes) <= set(ts.map.keyframes) | {max(js.map.keyframes)}


def _pose_err(Ta, Tb):
    dT = np.linalg.inv(Ta) @ Tb
    c = np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)
    return np.linalg.norm(dT[:3, 3]), np.arccos(c)


def test_same_features_same_step(both):
    """From identical features the step is the same: pose within 1e-3 m /
    1e-3 rad, and the same map point on >= 98 % of the matched keypoints."""
    _, (_, tf), _, jf, ds = both
    dt, dr = _pose_err(jf.Tcw, tf.Tcw)
    assert dt < 1e-3 and dr < 1e-3, (dt, dr)
    matched = (jf.points >= 0) | (tf.points >= 0)
    assert (jf.points[matched] == tf.points[matched]).mean() >= 0.98
    assert np.linalg.norm(np.linalg.inv(tf.Tcw)[:3, 3] - ds.poses[N][:3, 3]) < 0.2


def test_own_features(both):
    """With its own extraction the port sees >= 98 % identical keypoints
    (98.0 % measured against the x64-off reference), but above pyramid
    level 0 about one descriptor in ten differs in a few bits (the column
    pass of the pyramid is not bit-exact, see test_torch_image.py), which
    moves ratio tests near their threshold: the same map point on >= 95 %
    of the matched shared keypoints (95.8 % measured), and a pose within
    1.5 cm / 1e-3 rad of the reference's (1.09 cm / 4e-4 rad measured: a few
    differing observations of ~100 move it by mm).  From the same features
    the step is identical to 1e-3 (``test_same_features_same_step``)."""
    _, _, (_, tf), jf, _ = both
    same_kp = np.all(jf.kps == tf.kps, 1)
    assert same_kp.mean() >= 0.98
    matched = same_kp & ((jf.points >= 0) | (tf.points >= 0))
    assert (jf.points[matched] == tf.points[matched]).mean() >= 0.95
    dt, dr = _pose_err(jf.Tcw, tf.Tcw)
    assert dt < 1.5e-2 and dr < 1e-3, (dt, dr)
