"""Every feature-tracker preset of the port builds on the CPU through the
factory (split from tests/test_torch_import.py, so that the xdist workers
share its time): the weight-free ones run three frames of a stereo
session, the learned ones match a frame to a shifted copy of itself, and
every preset's configuration survives a JSON round trip."""

import pytest

from tests import torch_parity  # noqa: F401  (one small torch thread pool per worker)


def _presets():
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, FeatureTrackerConfigs

    return sorted(k for k, v in vars(FeatureTrackerConfigs).items()
                  if isinstance(v, FeatureTrackerConfig))


def _weight_free():
    from pyslam_tpu_torch.features.tracker import WEIGHT_FREE_PRESETS

    return list(WEIGHT_FREE_PRESETS)


@pytest.mark.parametrize("name", _weight_free())
def test_weight_free_preset_builds(name):
    """Every preset that needs no learned weights builds on the CPU through
    the factory, and ``Slam`` takes it and runs three stereo frames (the
    session's descriptor gates are restored afterwards)."""
    import numpy as np

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfigs, feature_tracker_factory
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    cfg = FeatureTrackerConfigs.get(name)
    tracker = feature_tracker_factory(name, device="cpu")
    assert tracker.device.type == "cpu" and tracker.config is cfg
    assert (type(tracker).__name__ == "LkFeatureTracker") == (cfg.tracker_type.name == "LK")
    img = np.tile(np.linspace(20, 200, 160, dtype=np.float32), (120, 1))
    img[40:80, 50:90] = 240.0
    fd = tracker.detectAndCompute(img)
    assert fd.xy.shape == (tracker.num_features, 2) and fd.desc.device.type == "cpu"
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset

    saved = {k: getattr(Parameters, k) for k in ("kMaxDescriptorDistance",
                                                 "kMaxOrbDistanceSearchByReproj")}
    try:
        # three frames of a small stereo stream: initialisation, then
        # tracking against the map (projection search at the preset's levels)
        ds = SyntheticDataset(num_frames=3, h=120, w=160, fx=100.0,
                              sensor_type=SensorType.STEREO, trajectory="line", step=0.2)
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, bf=ds.fx * ds.baseline,
                            depth_threshold=20.0)
        slam = Slam(cam, name, sensor_type=SensorType.STEREO, device="cpu")
        assert slam.feature_tracker.config.name == name
        for i in range(3):
            slam.track(ds.getImage(i), img_right=ds.getImageRight(i), frame_id=i,
                       timestamp=ds.getTimestamp(i))
    finally:
        for k, v in saved.items():
            setattr(Parameters, k, v)


@pytest.mark.parametrize("name", [n for n in _presets() if n not in _weight_free()])
def test_learned_preset_refused(name, monkeypatch):
    """No learned preset is refused any more: every one is in
    ``PORTED_PRESETS`` and builds on the CPU through the factory, with the
    JAX package's bundled weights (SUPERPOINT, LIGHTGLUE: ``trained``) or
    seeded random ones (the others: not ``trained``), at 256 keypoint
    slots, and matches a frame to a shifted copy of itself once; the
    descriptors have the preset's width (``DESCRIPTOR_WIDTH``).  MAST3R
    runs its two-view network at a small width here (desc_dim 24), LOFTR
    (detector-free: ``detectAndCompute`` raises) at its full width on a
    64x96 input, through ``track_pair``."""
    import dataclasses

    import numpy as np
    import torch

    from pyslam_tpu_torch.features.tracker import (
        PORTED_PRESETS,
        FeatureTrackerConfigs,
        feature_tracker_factory,
    )
    from pyslam_tpu_torch.features.types import DESCRIPTOR_WIDTH

    assert name in PORTED_PRESETS
    cfg = FeatureTrackerConfigs.get(name)
    if name == "MAST3R":
        from pyslam_tpu_torch.models import mast3r

        tiny = mast3r.Mast3rConfig(img_hw=(64, 64), patch=16, enc_dim=32, enc_depth=2,
                                   enc_heads=2, dec_dim=48, dec_depth=2, dec_heads=2)
        monkeypatch.setattr(mast3r.Mast3rModel, "default_config", staticmethod(lambda: tiny))
    small = {"extra": {"img_hw": (64, 96)}} if name == "LOFTR" else {}
    tracker = feature_tracker_factory(dataclasses.replace(cfg, num_features=256, **small),
                                      device="cpu")
    assert tracker.device.type == "cpu"
    assert tracker.trained == (name in ("SUPERPOINT", "LIGHTGLUE"))
    assert tracker.norm.name == "L2"
    glue = getattr(tracker.matcher, "glue", None)
    assert (glue is not None) == (cfg.tracker_type.name == "LIGHTGLUE")
    r = np.random.default_rng(0)
    img = np.full((120, 160), 60.0, np.float32)
    for _ in range(30):
        y, x = r.integers(8, 100), r.integers(8, 140)
        img[y:y + 12, x:x + 12] = r.uniform(120, 250)
    if name == "LOFTR":
        with pytest.raises(NotImplementedError):
            tracker.detectAndCompute(img)
        xy1, xy2, conf = tracker.track_pair(img, np.roll(img, 2, axis=1))
        assert xy1.shape == xy2.shape and xy1.shape[1] == 2 and conf.shape == (len(xy1),)
        return
    f1 = tracker.detectAndCompute(img)
    f2 = tracker.detectAndCompute(np.roll(img, 2, axis=1))
    width = DESCRIPTOR_WIDTH[cfg.descriptor_type]
    assert f1.desc.shape == (tracker.num_features, width) and f1.desc.device.type == "cpu"
    assert bool(f1.valid.any()) and bool(torch.isfinite(f1.desc).all())
    i1, i2 = tracker.match(f1, f2)
    assert isinstance(i1, np.ndarray) and len(i1) == len(i2)
    assert (i2 < tracker.num_features).all()


def test_tracker_config_json_round_trip():
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, FeatureTrackerConfigs

    for name in _presets():
        cfg = FeatureTrackerConfigs.get(name)
        back = FeatureTrackerConfig.from_json(cfg.to_json())
        assert back.to_json() == cfg.to_json()
    with pytest.raises(KeyError):
        FeatureTrackerConfigs.get("NO_SUCH_PRESET")
