"""DUSt3R and MASt3R in the port (pyslam_tpu_torch/models/{dust3r,mast3r}.py)
against the JAX package's, with its ``PRNGKey(0)`` weights carried across
(``interop.dust3r_state_dict`` / ``mast3r_state_dict``), the JAX package
run with x64 off: the ``TINY`` configurations of tests/test_dust3r.py and
tests/test_mast3r.py.

Tolerances: every map (points, confidences, descriptors, descriptor
confidences) within 1e-4 of its largest magnitude; ``reciprocal_nn_matches``
identical on the same maps; the MAST3R tracker's ``detectAndCompute``
keypoints identical, their descriptors within 1e-4; ``match_pair`` and
``track_pair`` the same points.  ``dust3r_from_torch_file`` loads a state
dict under the official names (``model`` entry, ``module.`` prefix) into
the port and the JAX package's converter the same dict: the same maps.
A six-frame MAST3R stereo session through ``Slam.track()`` on the 120x160
line stream tracks the frames the JAX package tracks (frame 0, then lost:
random weights) with the same map.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models import dust3r as jdust3r
from pyslam_tpu.models import mast3r as jmast3r
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import dust3r, mast3r
from tests.torch_parity import compiled_flax_init, flat_variables, rel_err, rng, t

TOL = 1e-4
D_TINY = dict(img_hw=(32, 48), patch=8, enc_dim=32, enc_depth=2, enc_heads=2,
              dec_dim=24, dec_depth=2, dec_heads=2)
M_TINY = dict(img_hw=(64, 64), patch=16, enc_dim=32, enc_depth=2, enc_heads=2,
              dec_dim=48, dec_depth=2, dec_heads=2, desc_dim=8)


@pytest.fixture(scope="module")
def dust():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jdust3r.Dust3rModel(jdust3r.Dust3rConfig(**D_TINY))
    got = dust3r.Dust3rModel(dust3r.Dust3rConfig(**D_TINY), device="cpu")
    assert not got.trained
    got.net.load_state_dict(interop.dust3r_state_dict(flat_variables(ref.params)))
    return ref, got


@pytest.fixture(scope="module")
def mast():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jmast3r.Mast3rModel(jmast3r.Mast3rConfig(**M_TINY))
    got = mast3r.Mast3rModel(mast3r.Mast3rConfig(**M_TINY), device="cpu")
    got.net.load_state_dict(interop.mast3r_state_dict(flat_variables(ref.params)))
    return ref, got


def _images(seed, hw, gray=False):
    r = rng(seed)
    shape = hw if gray else (*hw, 3)
    return (r.uniform(0, 255, shape).astype(np.float32),
            r.uniform(0, 255, shape).astype(np.float32))


def test_dust3r_maps(dust):
    ref, got = dust
    a, b = _images(0, (60, 90))                         # odd size: resampled to 32x48
    with jax.enable_x64(False):
        want = ref.infer_pair(a, b)
    out = got.infer_pair(a, b)
    assert out[0].shape == (32, 48, 3) and out[1].shape == (32, 48)
    for g, w in zip(out, want):
        assert rel_err(g, w) <= TOL


def test_mast3r_maps(mast):
    ref, got = mast
    a, b = _images(1, (64, 64))
    with jax.enable_x64(False):
        want = ref.infer_pair(a, b)
    out = got.infer_pair(a, b)
    for gv, wv in zip(out, want):
        for g, w in zip(gv, wv):
            assert rel_err(g, w) <= TOL
    assert torch.allclose(torch.linalg.vector_norm(out[0][2], dim=-1), torch.ones(1), atol=1e-4)


def test_reciprocal_nn_matches_identical(mast):
    ref, got = mast
    a, b = _images(2, (64, 64))
    with jax.enable_x64(False):
        (_, _, d1, c1), (_, _, d2, c2) = ref.infer_pair(a, b)
        want = jmast3r.reciprocal_nn_matches(*map(jnp.asarray, (d1, c1, d2, c2)), k=1024)
    gotm = mast3r.reciprocal_nn_matches(*map(t, (d1, c1, d2, c2)), k=1024)
    for g, w in zip(gotm, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # ties: the self-matches of a map with repeated confidences
    r = rng(3)
    d = r.normal(0, 1, (16, 16, 8)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = np.round(r.uniform(1, 2, (16, 16)), 1).astype(np.float32)
    with jax.enable_x64(False):
        want = jmast3r.reciprocal_nn_matches(*map(jnp.asarray, (d, c, d, c)), k=64)
    gotm = mast3r.reciprocal_nn_matches(*map(t, (d, c, d, c)), k=64)
    for g, w in zip(gotm, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_match_pair(mast):
    ref, got = mast
    a, b = _images(4, (64, 64))
    with jax.enable_x64(False):
        want = ref.match_pair(a, b, conf_min=1.0)
    out = got.match_pair(a, b, conf_min=1.0)
    assert len(want[0]) >= 10
    _same_matches(out, want)


def _same_matches(got, want):
    """The same (xy1, xy2) pairs (the order follows the confidences, whose
    near-ties float32 rounding orders either way) with scores within TOL
    of the largest."""
    def rows(m):
        xy = np.concatenate([m[0], m[1]], 1)
        order = np.lexsort(xy.T[::-1])
        return xy[order], m[2][order]

    (g, gs), (w, ws) = rows(got), rows(want)
    np.testing.assert_array_equal(g, w)
    assert rel_err(gs, ws) <= TOL


def _trackers(mast, monkeypatch):
    ref, got = mast
    from pyslam_tpu.features import tracker as jtracker
    from pyslam_tpu_torch.features import tracker

    monkeypatch.setattr("pyslam_tpu.models.mast3r.Mast3rModel", lambda checkpoint=None: ref)
    monkeypatch.setattr("pyslam_tpu_torch.models.mast3r.Mast3rModel",
                        lambda checkpoint=None, device="cuda": got)
    cfg_j = dataclasses.replace(jtracker.FeatureTrackerConfigs.MAST3R, num_features=300)
    cfg_p = dataclasses.replace(tracker.FeatureTrackerConfigs.MAST3R, num_features=300)
    return (jtracker.feature_tracker_factory(cfg_j),
            tracker.feature_tracker_factory(cfg_p, device="cpu"))


def test_detect_and_compute(mast, monkeypatch):
    jt, pt = _trackers(mast, monkeypatch)
    assert type(pt).__name__ == "Mast3rFeatureTracker" and not pt.trained
    img = rng(5).uniform(0, 255, (48, 64)).astype(np.float32)
    with jax.enable_x64(False):
        fr = jt.detectAndCompute(img)
        ri1, ri2 = jt.match(fr, fr)
        rp = jt.track_pair(img, np.roll(img, 2, axis=1))
    f = pt.detectAndCompute(img)
    np.testing.assert_array_equal(f.xy.numpy(), np.asarray(fr.xy))
    np.testing.assert_array_equal(f.valid.numpy(), np.asarray(fr.valid))
    assert np.abs(f.desc.numpy() - np.asarray(fr.desc)).max() <= TOL
    assert np.abs(f.response.numpy() - np.asarray(fr.response)).max() <= TOL * 10
    i1, i2 = pt.match(f, f)
    np.testing.assert_array_equal(i1, ri1)
    np.testing.assert_array_equal(i2, ri2)
    _same_matches(pt.track_pair(img, np.roll(img, 2, axis=1)), rp)


def test_dust3r_from_torch_file(dust, tmp_path):
    """The official names: the port's state dict as an official checkpoint
    (``model`` entry, ``module.`` prefix), read by the port and by the JAX
    package's converter."""
    ref, got = dust
    sd = {f"module.{k}": v.clone() for k, v in got.net.state_dict().items()}
    path = str(tmp_path / "dust3r.pth")
    torch.save({"model": sd}, path)
    loaded = dust3r.Dust3rModel(dust3r.Dust3rConfig(**D_TINY), checkpoint=path, device="cpu")
    assert loaded.trained
    with jax.enable_x64(False):
        other = jdust3r.Dust3rModel(jdust3r.Dust3rConfig(**D_TINY))
        other.load_checkpoint(path)
        a, b = _images(6, (32, 48))
        want = other.infer_pair(a, b)
    for g, w in zip(loaded.infer_pair(a, b), want):
        assert rel_err(g, w) <= TOL


def test_mast3r_session(mast, monkeypatch):
    """MAST3R through ``Slam.track()`` in both packages: the same frames
    tracked, keyframes and map points."""
    from pyslam_tpu.io.dataset import SyntheticDataset as JDataset
    from pyslam_tpu.io.dataset_types import SensorType as JSensor
    from pyslam_tpu.slam.camera import PinholeCamera as JCamera
    from pyslam_tpu.slam.slam import Slam as JSlam
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    _trackers(mast, monkeypatch)
    n = 6
    ds = JDataset(num_frames=n, h=120, w=160, fx=100.0, sensor_type=JSensor.STEREO,
                  trajectory="line", step=0.2)
    frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i)) for i in range(n)]
    cam_args = (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    kw = dict(bf=ds.fx * ds.baseline, depth_threshold=20.0)
    from pyslam_tpu.config_parameters import Parameters as JParameters

    keys = ("kMaxDescriptorDistance", "kMaxOrbDistanceSearchByReproj")
    saved = [(P, {k: getattr(P, k) for k in keys}) for P in (Parameters, JParameters)]
    runs = []
    try:
        for slam in (JSlam(JCamera(*cam_args, **kw), "MAST3R", sensor_type=JSensor.STEREO),
                     Slam(PinholeCamera(*cam_args, **kw), "MAST3R",
                          sensor_type=SensorType.STEREO, device="cpu")):
            states = []
            with jax.enable_x64(False):
                for i, (l, r, ts) in enumerate(frames):
                    slam.track(l, img_right=r, frame_id=i, timestamp=ts)
                    states.append(slam.tracking.state.name)
            runs.append((states, len(slam.tracking.history.timestamps),
                         slam.map.num_keyframes(), slam.map.num_points()))
    finally:
        for P, values in saved:
            for k, v in values.items():
                setattr(P, k, v)
    assert runs[0][1] >= 1
    assert runs[1] == runs[0], runs
