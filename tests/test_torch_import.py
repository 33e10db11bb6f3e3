"""The port imports neither JAX nor the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

from tests import torch_parity  # noqa: F401  (one small torch thread pool per worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pyslam_tpu_torch")


def test_import_loads_no_jax():
    code = (
        "import sys, pyslam_tpu_torch, pyslam_tpu_torch.slam.slam, pyslam_tpu_torch.interop\n"
        "import pyslam_tpu_torch.dense.volumetric_integrator, pyslam_tpu_torch.dense.marching\n"
        "import pyslam_tpu_torch.depth_estimation.depth_estimator\n"
        "import pyslam_tpu_torch.loop_closing.loop_closing, pyslam_tpu_torch.ops.pnp\n"
        "import pyslam_tpu_torch.ops.lk, pyslam_tpu_torch.ops.epipolar, pyslam_tpu_torch.io.ground_truth\n"
        "import pyslam_tpu_torch.slam.visual_odometry, pyslam_tpu_torch.slam.visual_odometry_rgbd\n"
        "import pyslam_tpu_torch.features.surf, pyslam_tpu_torch.features.akaze\n"
        "import pyslam_tpu_torch.features.classical, pyslam_tpu_torch.features.binary_descriptors\n"
        "import pyslam_tpu_torch.features.matcher, pyslam_tpu_torch.ops.patches\n"
        "import pyslam_tpu_torch.io.dataset, pyslam_tpu_torch.io.dataset_factory\n"
        "import pyslam_tpu_torch.io.trajectory_writer, pyslam_tpu_torch.config\n"
        "import pyslam_tpu_torch.evaluation.manager, pyslam_tpu_torch.evaluation.report_formats\n"
        "import pyslam_tpu_torch.slam.map_serialization, pyslam_tpu_torch.slam.map_serialization_ref\n"
        "import pyslam_tpu_torch.main_slam, pyslam_tpu_torch.main_vo\n"
        "import pyslam_tpu_torch.main_slam_evaluation, pyslam_tpu_torch.main_feature_matching\n"
        "import pyslam_tpu_torch.models.loftr, pyslam_tpu_torch.models.dust3r\n"
        "import pyslam_tpu_torch.models.mast3r, pyslam_tpu_torch.models.netvlad\n"
        "import pyslam_tpu_torch.models.megaloc, pyslam_tpu_torch.models.depth_anything_v2\n"
        "import pyslam_tpu_torch.loop_closing.vpr, pyslam_tpu_torch.loop_closing.vlad\n"
        "import pyslam_tpu_torch.models.vggt, pyslam_tpu_torch.models.depth_anything\n"
        "import pyslam_tpu_torch.models.depth_anything_v3, pyslam_tpu_torch.models.depth_pro\n"
        "import pyslam_tpu_torch.models.raft_stereo, pyslam_tpu_torch.models.crestereo\n"
        "import pyslam_tpu_torch.models.mvdust3r, pyslam_tpu_torch.models.torch_convert\n"
        "import pyslam_tpu_torch.main_depth_prediction\n"
        "from pyslam_tpu_torch.depth_estimation.depth_estimator import depth_estimator_factory\n"
        "for t in ('depth_anything_v2', 'depth_anything_v3', 'mvdust3r', 'depth_pro'):\n"
        "    depth_estimator_factory(t, device='meta')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'pyslam_tpu' or m.startswith('pyslam_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_py_files()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "pyslam_tpu", "flax"), f"{path}: {n}"


def test_import_builds_nothing():
    """Importing the package must not compile or load the CUDA kernels."""
    import pyslam_tpu_torch  # noqa: F401
    from pyslam_tpu_torch import _build

    assert _build._lib is None


@pytest.mark.parametrize("name", ["slam.slam.Slam", "features.orb2.ORB2Extractor",
                                  "features.tracker.FeatureTracker",
                                  "features.tracker.feature_tracker_factory", "slam.map.Map",
                                  "dense.tsdf.TSDFVolume",
                                  "depth_estimation.depth_estimator.DepthEstimatorSgbm",
                                  "depth_estimation.depth_estimator.depth_estimator_factory",
                                  "dense.volumetric_integrator.VolumetricIntegrator",
                                  "dense.volumetric_integrator.volumetric_integrator_factory",
                                  "interop.voxel_table_from_numpy",
                                  "loop_closing.loop_closing.LoopClosing",
                                  "loop_closing.loop_closing.LoopDetector",
                                  "loop_closing.relocalizer.Relocalizer",
                                  "loop_closing.vocabulary.HierarchicalVocabulary",
                                  "loop_closing.vocabulary.BinaryVocabulary",
                                  "slam.global_bundle_adjustment.AsyncGBA",
                                  "slam.global_bundle_adjustment.build_full_problem",
                                  "slam.global_bundle_adjustment.global_bundle_adjustment",
                                  "slam.initializer.Initializer",
                                  "slam.visual_odometry_rgbd.VisualOdometryRgbd",
                                  "features.surf.SurfExtractor",
                                  "features.akaze.AkazeExtractor",
                                  "features.classical.ShiTomasiExtractor",
                                  "features.classical.CvSIFTExtractor",
                                  "features.tracker.LkFeatureTracker",
                                  "evaluation.manager.SlamEvaluationManager",
                                  "loop_closing.vocabulary.HierarchicalVocabulary.load",
                                  "loop_closing.vocabulary.BinaryVocabulary.load",
                                  "models.superpoint.SuperPointExtractor",
                                  "models.lightglue.LightGlueMatcher",
                                  "models.cosplace.CosPlaceExtractor",
                                  "models.loftr.LoFTRMatcher",
                                  "models.dust3r.Dust3rModel",
                                  "models.mast3r.Mast3rModel",
                                  "models.netvlad.NetVLADExtractor",
                                  "models.megaloc.MegaLocExtractor",
                                  "loop_closing.vpr.AlexNetExtractor",
                                  "loop_closing.vpr.HDCDelfExtractor",
                                  "loop_closing.vlad.VladVocabulary",
                                  "loop_closing.vocabulary.HierarchicalVocabulary.from_dbow3_text",
                                  "features.tracker.Mast3rFeatureTracker",
                                  "features.tracker.LoftrFeatureTracker",
                                  "features.matcher.LightGlueFeatureMatcher"])
def test_entry_points_default_to_the_card(name):
    """The entry points run on the card unless the caller asks for the CPU;
    ``device`` is keyword-only."""
    import importlib
    import inspect

    parts = name.split(".")
    for i in range(len(parts) - 1, 0, -1):   # the longest prefix that is a module
        try:
            obj = importlib.import_module("pyslam_tpu_torch." + ".".join(parts[:i]))
            break
        except ModuleNotFoundError:
            continue
    for attr in parts[i:]:
        obj = getattr(obj, attr)
    param = inspect.signature(obj).parameters["device"]
    assert param.default == "cuda"
    assert param.kind is inspect.Parameter.KEYWORD_ONLY


def test_loop_closing_slam_runs_on_the_card():
    """``Slam(..., loop_detector_config="DBOW3")`` without a device builds
    its loop closing on the card, and without one it refuses to start
    rather than carry on on the CPU."""
    import torch

    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    cam = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0, bf=40.0)
    cfg = FeatureTrackerConfig(num_features=300, num_levels=3)
    if torch.cuda.is_available():
        slam = Slam(cam, cfg, loop_detector_config="DBOW3", sensor_type=SensorType.STEREO)
        assert slam.loop_closing.device.type == "cuda"
        assert slam.loop_closing.relocalizer.device.type == "cuda"
        assert slam.GBA.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            Slam(cam, cfg, loop_detector_config="DBOW3", sensor_type=SensorType.STEREO)


@pytest.mark.parametrize("preset", ["VLAD", "SAD", "NETVLAD", "COSPLACE", "EIGENPLACES",
                                    "MEGALOC", "ALEXNET", "HDC_DELF", "PRETRAINED"])
def test_detector_refuses_what_is_not_ported(preset, tmp_path):
    """Nothing is refused any more: every detector preset of the JAX
    package and the pretrained vocabulary build on the CPU.  The
    score-based ones describe a frame by a unit global descriptor and no
    words (the image detectors set ``kRetainImageForVPR``; COSPLACE and
    EIGENPLACES with the bundled trained weights, the others seeded random
    ones); ``PRETRAINED`` loads ``extra["vocabulary_path"]`` (a vocabulary
    this test trains and saves) and describes it by its words."""
    import dataclasses
    from types import SimpleNamespace

    import numpy as np
    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
    from pyslam_tpu_torch.loop_closing.loop_detector_configs import (
        LoopDetectorConfigs, LoopDetectorVocabularyType)
    from pyslam_tpu_torch.loop_closing.vocabulary import HierarchicalVocabulary

    r = np.random.default_rng(0)
    des = r.integers(0, 2, (300, 256)).astype(np.int8)
    valid = np.ones(300, bool)
    if preset == "PRETRAINED":
        voc = HierarchicalVocabulary(branching=4, depth=3, device="cpu")
        voc.words_for(des, valid)
        voc.save(str(tmp_path / "voc.npz"))
        cfg = dataclasses.replace(LoopDetectorConfigs.DBOW3,
                                  vocabulary_type=LoopDetectorVocabularyType.PRETRAINED,
                                  extra={"vocabulary_path": str(tmp_path / "voc.npz")})
    else:
        cfg = LoopDetectorConfigs.get(preset)
    saved = Parameters.kRetainImageForVPR
    try:
        det = LoopDetector(cfg, device="cpu")
        assert Parameters.kRetainImageForVPR == (det.netvlad is not None or saved)
    finally:
        Parameters.kRetainImageForVPR = saved
    img = r.uniform(0, 255, (120, 160)).astype(np.uint8)
    tdes, tvalid = torch.from_numpy(des), torch.from_numpy(valid)
    frame = SimpleNamespace(img_vpr=img, img_thumb=img[:64].astype(np.float32), des=des,
                            valid=valid, dev=lambda name: {"des": tdes, "valid": tvalid}[name])
    words, g = det.describe_frame(frame)
    if preset == "PRETRAINED":
        assert not det.score_based and det.vocabulary.checksum() == voc.checksum()
        np.testing.assert_array_equal(words, voc.words_for(des, valid))
        return
    assert det.score_based and words is None
    if preset in ("COSPLACE", "EIGENPLACES"):
        assert det.netvlad.trained and g.shape == (det.netvlad.out_dim,)
    assert abs(np.linalg.norm(g) - 1.0) < 1e-5


@pytest.mark.parametrize("preset", ["DBOW2", "DBOW3", "DBOW3_INDEPENDENT", "IBOW"])
def test_detector_builds_bow_presets(preset):
    from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
    from pyslam_tpu_torch.loop_closing.loop_detector_configs import LoopDetectorConfigs

    det = LoopDetector(LoopDetectorConfigs.get(preset), device="cpu")
    assert det.vocabulary.device.type == "cpu"


@pytest.mark.parametrize("sensor", ["RGBD", "MONOCULAR", "STEREO"])
def test_every_sensor_builds(sensor):
    """Slam accepts every sensor the JAX package supports, and a camera with
    distortion coefficients."""
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    cam = PinholeCamera(640, 480, 517.3, 516.5, 318.6, 255.3, bf=40.0,
                        D=[0.2624, -0.9531, -0.0054, 0.0026, 1.1633])
    assert cam.is_distorted and cam.u_min != 0.0
    slam = Slam(cam, FeatureTrackerConfig(num_features=300, num_levels=3),
                sensor_type=SensorType[sensor], device="cpu")
    assert slam.sensor_type == SensorType[sensor]


def test_depth_estimator_upgrade_refused():
    """The monocular -> RGBD upgrade by a depth estimator is refused only
    for an estimator on another device than the session's; on its device
    the session runs as RGBD."""
    from pyslam_tpu_torch.depth_estimation.depth_estimator import depth_estimator_factory
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    cam = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0)
    cfg = FeatureTrackerConfig(num_features=300, num_levels=3)
    with pytest.raises(ValueError):
        Slam(cam, cfg, sensor_type=SensorType.MONOCULAR,
             depth_estimator=depth_estimator_factory("sgbm", camera=cam, device="meta"),
             device="cpu")
    slam = Slam(cam, cfg, sensor_type=SensorType.MONOCULAR,
                depth_estimator=depth_estimator_factory("sgbm", camera=cam, device="cpu"),
                device="cpu")
    assert slam.sensor_type == SensorType.RGBD


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

