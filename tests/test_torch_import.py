"""The port imports neither JAX nor the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

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
                                  "slam.visual_odometry_rgbd.VisualOdometryRgbd"])
def test_entry_points_default_to_the_card(name):
    """The entry points run on the card unless the caller asks for the CPU;
    ``device`` is keyword-only."""
    import importlib
    import inspect

    mod, attr = name.rsplit(".", 1)
    obj = getattr(importlib.import_module(f"pyslam_tpu_torch.{mod}"), attr)
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
def test_detector_refuses_what_is_not_ported(preset):
    """The learned VPR, VLAD and SAD detectors and the pretrained
    vocabulary raise NotImplementedError; the BoW presets build."""
    import dataclasses

    from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
    from pyslam_tpu_torch.loop_closing.loop_detector_configs import (
        LoopDetectorConfigs, LoopDetectorVocabularyType)

    if preset == "PRETRAINED":
        cfg = dataclasses.replace(LoopDetectorConfigs.DBOW3,
                                  vocabulary_type=LoopDetectorVocabularyType.PRETRAINED)
    else:
        cfg = LoopDetectorConfigs.get(preset)
    with pytest.raises(NotImplementedError):
        LoopDetector(cfg, device="cpu")


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
    """The monocular -> RGBD upgrade by a depth estimator needs the learned
    estimators, which are not ported."""
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    cam = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0)
    with pytest.raises(NotImplementedError):
        Slam(cam, FeatureTrackerConfig(num_features=300, num_levels=3),
             sensor_type=SensorType.MONOCULAR, depth_estimator=object(), device="cpu")
