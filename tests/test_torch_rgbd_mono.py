"""The RGBD and monocular frame paths and the Initializer of the port
against the JAX package, fed the same JAX-extracted features (the 240x320
synthetic streams of tests/test_slam_e2e.py, 600 features on 4 levels),
the reference with x64 off as it runs outside this suite.

Tolerances: ``compute_stereo_from_rgbd`` identical (discrete reads and one
exactly rounded division), with and without lens distortion, and through
the port's own Frame constructor; the RGBD initialisation identical (the
same keyframe, points and positions to 1e-6 m).  Monocular: given the
reference's essential matrix and pose for each attempt, the port's
initializer decides at the same frame and keeps the same points, with T21
and the map points within 1e-6; end to end (its own RANSAC from the
reference's samples, ``tests.torch_parity.JaxKeySampler(42)``) the
float32 8-point's conditioning (tests/test_torch_epipolar.py) lets the
packages part: both initialise within one frame of each other, with a
rotation within 2e-2 rad and a unit translation within 0.3 of the
ground truth (measured: the reference at frame 2 with 0.008 rad and
0.089, the port at frame 1 with 0.005 rad and 0.15)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import JaxKeySampler

from pyslam_tpu.features.orb2 import featuredata_to_numpy
from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.features.tracker import feature_tracker_factory as jax_tracker_factory
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.ops import epipolar as jepi
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.frame import Frame as JaxFrame
from pyslam_tpu.slam.initializer import Initializer as JaxInitializer
from pyslam_tpu.slam.map import Map as JaxMap
from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.slam import initializer as init_mod
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.frame import Frame, compute_stereo_from_rgbd
from pyslam_tpu_torch.slam.initializer import Initializer
from pyslam_tpu_torch.slam.map import Map

N_MONO = 7
TUM_D = [0.262383, -0.953104, -0.005358, 0.002628, 1.163314]


def _cams(ds, D=None):
    args = (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    kw = dict(D=D, fps=ds.fps, bf=ds.fx * ds.baseline, depth_threshold=20.0)
    return JaxCamera(*args, **kw), PinholeCamera(*args, **kw)


def _port_frame(jf, cam, tracker):
    f = Frame(cam, feature_tracker=tracker, frame_id=jf.id, timestamp=jf.timestamp)
    f.set_host_fields(kps=jf.kps.copy(), levels=jf.levels.copy(), angles=jf.angles.copy(),
                      sizes=jf.sizes.copy(), valid=jf.valid.copy(), kps_ur=jf.kps_ur.copy(),
                      depths=jf.depths.copy(), kps_raw=jf.kps_raw.copy())
    f.des = np.asarray(jf.des)
    return f


@pytest.fixture(scope="module")
def rgbd():
    with jax.enable_x64(False):
        ds = JaxSyntheticDataset(num_frames=3, sensor_type=JaxSensorType.RGBD,
                                 trajectory="line", step=0.3)
        jt = jax_tracker_factory(JaxTrackerConfig(num_features=600, num_levels=4))
        frames = [(ds.getImage(i).astype(np.float32), ds.getDepth(i).astype(np.float32))
                  for i in range(3)]
        feats = [featuredata_to_numpy(jt.detectAndCompute(img)) for img, _ in frames]
    return ds, jt, frames, feats


@pytest.mark.parametrize("distorted", [False, True])
def test_compute_stereo_from_rgbd(rgbd, distorted):
    ds, jt, frames, feats = rgbd
    jcam, cam = _cams(ds, TUM_D if distorted else None)
    for (img, depth), fd in zip(frames, feats):
        with jax.enable_x64(False):
            jf = JaxFrame(jcam, depth=depth, feature_tracker=jt, features=fd)
        ur, z = compute_stereo_from_rgbd(
            torch.from_numpy(jf.kps), torch.from_numpy(np.asarray(fd.xy, np.float32)),
            torch.from_numpy(np.asarray(fd.valid)), torch.from_numpy(depth), cam.bf,
            Parameters.kMinDepth)
        np.testing.assert_array_equal(z.numpy(), jf.depths)
        np.testing.assert_array_equal(ur.numpy(), jf.kps_ur)
        assert (z.numpy() > 0).sum() > 100


@pytest.mark.parametrize("distorted", [False, True])
def test_rgbd_frame_constructor(rgbd, distorted):
    """The port's own RGBD Frame (extraction, undistortion, virtual right
    coordinates) against a JAX frame built from the port's features."""
    ds, jt, frames, _ = rgbd
    jcam, cam = _cams(ds, TUM_D if distorted else None)
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=600, num_levels=4),
                                      device="cpu")
    img, depth = frames[1]
    f = Frame(cam, img, depth=depth, feature_tracker=tracker, frame_id=1)
    fd = f.feature_tracker.detectAndCompute(img)
    from pyslam_tpu.features.orb2 import FeatureData as JaxFeatureData

    jfd = JaxFeatureData(*[np.asarray(x.numpy()) for x in fd])
    with jax.enable_x64(False):
        jf = JaxFrame(jcam, depth=depth, feature_tracker=jt, features=jfd)
    np.testing.assert_array_equal(f.kps_raw, jf.kps_raw)
    np.testing.assert_array_equal(f.kps, jf.kps)
    np.testing.assert_array_equal(f.depths, jf.depths)
    np.testing.assert_array_equal(f.kps_ur, jf.kps_ur)
    np.testing.assert_array_equal(f.dev("kps_ur").numpy(), jf.kps_ur)


def test_rgbd_initializer(rgbd):
    ds, jt, frames, feats = rgbd
    jcam, cam = _cams(ds)
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=600, num_levels=4),
                                      device="cpu")
    with jax.enable_x64(False):
        jf = JaxFrame(jcam, depth=frames[0][1], feature_tracker=jt, features=feats[0], frame_id=0)
        jout = JaxInitializer(JaxSensorType.RGBD, 600).initialize(jf, JaxMap())
    f = _port_frame(jf, cam, tracker)
    pm = Map(device="cpu")
    out = Initializer(SensorType.RGBD, 600, device="cpu").initialize(f, pm)
    assert out.success and jout.success
    np.testing.assert_array_equal(out.kf_cur.points >= 0, jout.kf_cur.points >= 0)
    np.testing.assert_allclose(pm.points.pos[out.pids], jout.kf_cur.unproject_keypoints(
        np.nonzero(jout.kf_cur.points >= 0)[0])[0], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def mono():
    with jax.enable_x64(False):
        ds = JaxSyntheticDataset(num_frames=N_MONO, sensor_type=JaxSensorType.MONOCULAR,
                                 trajectory="line", step=0.4)
        jcam, cam = _cams(ds)
        jt = jax_tracker_factory(JaxTrackerConfig(num_features=600, num_levels=4))
        jframes = [JaxFrame(jcam, ds.getImage(i).astype(np.float32), feature_tracker=jt,
                            frame_id=i, timestamp=ds.getTimestamp(i)) for i in range(N_MONO)]
        for f in jframes:
            _ = f.des
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=600, num_levels=4),
                                      device="cpu")
    return ds, jframes, cam, tracker


def _run_reference(jframes):
    with jax.enable_x64(False):
        init, m = JaxInitializer(JaxSensorType.MONOCULAR, 600), JaxMap()
        for i, f in enumerate(jframes):
            out = init.initialize(f, m)
            if out.success:
                return i, out, m
    return None, None, None


def _run_port(jframes, cam, tracker, sampler):
    frames = [_port_frame(f, cam, tracker) for f in jframes]
    init, m = Initializer(SensorType.MONOCULAR, 600, device="cpu", sampler=sampler), \
        Map(device="cpu")
    for i, f in enumerate(frames):
        out = init.initialize(f, m)
        if out.success:
            return i, out, m
    return None, None, None


def test_mono_initializer_given_the_reference_geometry(mono, monkeypatch):
    """The port's initializer around the reference's own RANSAC: each
    attempt's E, mask and pose come from the JAX package (its key split as
    the reference splits it), the rest is the port's."""
    ds, jframes, cam, tracker = mono
    keys = [jax.random.PRNGKey(42)]

    def find_essential(xy1, xy2, valid, th, num_hyp, samples=None):
        with jax.enable_x64(False):
            keys[0], k = jax.random.split(keys[0])
            E, m, n = jepi.find_essential(k, jnp.asarray(xy1.numpy()), jnp.asarray(xy2.numpy()),
                                          jnp.asarray(valid.numpy()), th, num_hyp)
        return (torch.from_numpy(np.array(E)), torch.from_numpy(np.array(m)),
                torch.tensor(int(n)))

    def recover_pose(E, xy1, xy2, mask):
        with jax.enable_x64(False):
            T, front = jepi.recover_pose(jnp.asarray(E.numpy()), jnp.asarray(xy1.numpy()),
                                         jnp.asarray(xy2.numpy()), jnp.asarray(mask.numpy()))
        return torch.from_numpy(np.array(T)), torch.from_numpy(np.array(front))

    monkeypatch.setattr(init_mod.epipolar, "find_essential", find_essential)
    monkeypatch.setattr(init_mod.epipolar, "recover_pose", recover_pose)
    ji, jout, jm = _run_reference(jframes)
    pi, out, pm = _run_port(jframes, cam, tracker, sampler=lambda *a, **k: None)
    assert ji is not None and pi == ji
    np.testing.assert_allclose(out.kf_cur.Tcw, jout.kf_cur.Tcw, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.kf_ref.points >= 0, jout.kf_ref.points >= 0)
    np.testing.assert_array_equal(out.kf_cur.points >= 0, jout.kf_cur.points >= 0)
    assert len(out.pids) == len(jout.pids) >= 75
    np.testing.assert_allclose(pm.points.pos[out.pids], jm.points.pos[jout.pids], rtol=0,
                               atol=1e-6)
    assert pm.num_keyframes() == 2


def test_mono_initializer_end_to_end(mono):
    ds, jframes, cam, tracker = mono
    ji, jout, _ = _run_reference(jframes)
    pi, out, pm = _run_port(jframes, cam, tracker, JaxKeySampler(42))
    assert ji is not None and pi is not None and abs(pi - ji) <= 1, (pi, ji)
    for o, i in ((out, pi), (jout, ji)):
        T = o.kf_cur.Tcw                      # cam0 -> cam i; the truth: R = I, t along -z
        c = (np.trace(T[:3, :3]) - 1) / 2
        assert np.arccos(np.clip(c, -1, 1)) <= 2e-2, i
        t = T[:3, 3] / np.linalg.norm(T[:3, 3])
        assert np.linalg.norm(t - [0.0, 0.0, -1.0]) <= 0.3, (i, t)
    assert len(out.pids) >= 75 and pm.num_keyframes() == 2
    # median scene depth normalised to 1 in the first keyframe
    kf0 = out.kf_ref
    pc = pm.points.pos[out.pids] @ kf0.Tcw[:3, :3].T + kf0.Tcw[:3, 3]
    assert abs(np.median(pc[:, 2]) - 1.0) < 0.05


def test_distorted_stereo_frame(monkeypatch):
    """A stereo pair of a distorted camera: both images extracted apart, the
    left keypoints undistorted, then the row match (the reference's
    unfused branch, ``compute_stereo_matches``); identical from the same
    features."""
    with jax.enable_x64(False):
        ds = JaxSyntheticDataset(num_frames=1, sensor_type=JaxSensorType.STEREO,
                                 trajectory="line", step=0.4)
        jcam, cam = _cams(ds, TUM_D)
        jt = jax_tracker_factory(JaxTrackerConfig(num_features=600, num_levels=4))
        left = ds.getImage(0).astype(np.float32)
        right = ds.getImageRight(0).astype(np.float32)
        jf = JaxFrame(jcam, left, img_right=right, feature_tracker=jt, frame_id=0)
        feats = {id(img): featuredata_to_numpy(jt.detectAndCompute(img))
                 for img in (left, right)}
    from pyslam_tpu_torch.features.orb2 import FeatureData

    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=600, num_levels=4),
                                      device="cpu")
    port_feats = {k: FeatureData(*[torch.from_numpy(np.array(x)) for x in fd])
                  for k, fd in feats.items()}
    monkeypatch.setattr(tracker, "detectAndCompute", lambda img: port_feats[id(img)])
    f = Frame(cam, left, img_right=right, feature_tracker=tracker, frame_id=0)
    np.testing.assert_array_equal(f.kps, jf.kps)
    np.testing.assert_array_equal(f.kps_raw, jf.kps_raw)
    np.testing.assert_array_equal(f.kps_ur, jf.kps_ur)
    np.testing.assert_array_equal(f.depths, jf.depths)
    assert (f.depths > 0).sum() > 100
