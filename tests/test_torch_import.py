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
        "import pyslam_tpu_torch.models.deeplabv3, pyslam_tpu_torch.models.segformer\n"
        "import pyslam_tpu_torch.models.clip, pyslam_tpu_torch.models.yolo_seg\n"
        "import pyslam_tpu_torch.models.detr, pyslam_tpu_torch.semantics.semantic_eval\n"
        "import pyslam_tpu_torch.semantics.semantic_mapping, pyslam_tpu_torch.dense.semantic_volume\n"
        "import pyslam_tpu_torch.main_semantic_image_segmentation\n"
        "import pyslam_tpu_torch.models.fast3r, pyslam_tpu_torch.ops.gaussian_splatting\n"
        "import pyslam_tpu_torch.scene_from_views.scene_from_views\n"
        "import pyslam_tpu_torch.dense.gaussian_splatting_integrator\n"
        "import pyslam_tpu_torch.main_scene_from_views\n"
        "import pyslam_tpu_torch.main_map_dense_reconstruction\n"
        "import pyslam_tpu_torch.models.train_superpoint, pyslam_tpu_torch.models.train_lightglue\n"
        "import pyslam_tpu_torch.models.train_cosplace, pyslam_tpu_torch.main_map_viewer\n"
        "import pyslam_tpu_torch.io.colmap_io, pyslam_tpu_torch.io.ros1bag\n"
        "import pyslam_tpu_torch.io.ros2bag, pyslam_tpu_torch.io.mcap_io\n"
        "import pyslam_tpu_torch.viz.html_viewer, pyslam_tpu_torch.viz.live_viewer\n"
        "import pyslam_tpu_torch.viz.viewer3d\n"
        "import pyslam_tpu_torch.native, pyslam_tpu_torch.pipeline\n"
        "import pyslam_tpu_torch.parallel.mesh, pyslam_tpu_torch.parallel.sharded_ba\n"

        "from pyslam_tpu_torch.semantics.semantic_segmentation import semantic_segmentation_factory\n"
        "for t in ('deeplabv3', 'segformer', 'yolo', 'rf_detr'):\n"
        "    semantic_segmentation_factory(t, device='meta')\n"
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


JAX_PKG = os.path.join(ROOT, "pyslam_tpu")


def _top_level(path, with_imports=False):
    """The names a module binds at its top level (defs, classes,
    assignments; with ``with_imports`` its imports too), and for each class
    the names its body defines."""
    tree = ast.parse(open(path).read(), path)
    names, members = set(), {}
    body = list(tree.body)
    while body:
        node = body.pop(0)
        if isinstance(node, (ast.If, ast.Try)):
            body += node.body + node.orelse + getattr(node, "finalbody", [])
            body += [s for h in getattr(node, "handlers", []) for s in h.body]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                members[node.name] = {n.name for n in node.body
                                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                names |= {e.id for e in ast.walk(t) if isinstance(e, ast.Name)}
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names, members


# Public names of a JAX module that the port keeps under another name or in
# another module ("module::Name" or "module::Class.method" in the port).
MOVED = {
    ("io/dataset.py", "SyntheticDataset"): "io/synthetic.py::SyntheticDataset",
    ("io/dataset.py", "SyntheticWorld"): "io/synthetic.py::SyntheticWorld",
    ("models/netvlad.py", "VGG16Conv5"): "models/netvlad.py::vgg16_conv5",
    ("ops/geometry.py", "backproject"): "slam/camera.py::PinholeCamera.backproject_points",
    ("ops/pallas_fast.py", "fast_score_map_pallas"): "ops/fast.py::fast_nms",
    # the port's matchers take a (B,)-stacked batch themselves, gathered
    # from the keyframe store by the caller
    ("ops/slam_matching.py", "epipolar_triangulation_match_batch"):
        "ops/slam_matching.py::epipolar_triangulation_match",
    ("ops/slam_matching.py", "epipolar_triangulation_match_kfstore"):
        "ops/slam_matching.py::epipolar_triangulation_match",
    ("ops/slam_matching.py", "fuse_candidates_batch"): "ops/slam_matching.py::fuse_candidates_kfstore",
    ("ops/slam_matching.py", "fuse_candidates_store_batch"):
        "ops/slam_matching.py::fuse_candidates_kfstore",
    **{(f"models/{m}.py", f"{n}_from_torch"): f"models/torch_convert.py::{n}_from_torch"
       for m, n in (("aliked", "aliked"), ("d2net", "d2net"), ("disk", "disk"),
                    ("keynet", "keynet"), ("r2d2", "r2d2"), ("resnet", "resnet"),
                    ("cosplace", "cosplace"), ("deeplabv3", "deeplabv3"), ("loftr", "loftr"),
                    ("patch_descriptors", "hardnet"), ("patch_descriptors", "sosnet"),
                    ("patch_descriptors", "tfeat"))},
}

# Public names of the JAX package with no counterpart in the port, each with
# its reason (ROADMAP.md section 1, item 5).
XLA_HELPER = ("an XLA batching, fixed-shape or readback helper: eager PyTorch needs no "
              "vmap, no padding ladder and no packed readback")
FLAX_CONVERTER = ("a converter of torch weights into flax variable trees: the port loads "
                  "torch state dicts as they are (models/torch_convert.py, interop.py)")
UNCALLED = "called by no code of the JAX package outside its own tests"
NOT_PORTED = {
    "features/orb2.py": {"featuredata_to_numpy": XLA_HELPER},
    "ops/fused_tracking.py": {
        "track_frame_fused_meta": XLA_HELPER + " (the packed-meta readback)",
        "track_frame_fused_chained": XLA_HELPER + " (the depth-2 chained tracking)"},
    "slam/map.py": {"DELTA_BUCKET_FULL": XLA_HELPER + " (fixed delta-upload buckets)",
                    "DELTA_BUCKET_POS": XLA_HELPER + " (fixed delta-upload buckets)"},
    "utils/padding.py": dict.fromkeys(("bucket_size_linear", "cap_select", "fixed_shapes",
                                       "pad_fixed", "pow2", "set_fixed_shape_policy"),
                                      XLA_HELPER + " (the fixed-shape ladder)"),
    "ops/pallas_fast.py": dict.fromkeys(("BAND", "HALO"),
                                        "the Pallas kernel's band tiling: csrc/fast_nms.cu "
                                        "tiles for Hopper"),
    "ops/nms.py": {"NEG": "the -inf of XLA's top-k mask, written in place in the port"},
    "models/lightglue.py": {"rotary_embed": "one product, xy @ w, written in place in "
                                            "LightGlueNet.forward"},
    "utils/profiling.py": dict.fromkeys(("DeviceCounters", "device_counters", "annotate"),
                                        "counts XLA dispatches or names XLA trace spans: "
                                        "torch.profiler counts the port's launches"),
    "models/patch_descriptors.py": dict.fromkeys(("l2net_from_torch", "logpolar_from_torch"),
                                                 FLAX_CONVERTER),
    "models/torch_convert.py": dict.fromkeys(
        ("dust3r_from_torch", "flatten_tree", "generic_from_torch", "lightglue_from_torch_file",
         "load_variables_npz", "netvlad_from_torch", "save_variables_npz",
         "superpoint_from_torch", "superpoint_from_torch_file", "xfeat_from_torch_file"),
        FLAX_CONVERTER),
    "ops/fast.py": {"harris_score_map": UNCALLED},
    "ops/geometry.py": {"skew_matmul_F": UNCALLED,
                        "project_points": UNCALLED + " (PinholeCamera.project_points wraps "
                                                     "it, and nothing calls that)"},
    "ops/image.py": dict.fromkeys(("laplacian_variance", "nearest_sample"), UNCALLED),
    "ops/lie.py": dict.fromkeys(("quat_to_R", "se3_inv", "vee"), UNCALLED),
    "ops/orb.py": dict.fromkeys(("brief_descriptors", "keypoint_angles"), UNCALLED),
    "semantics/semantic_mapping.py": {"SemanticMappingType": UNCALLED},
    "utils/logging.py": {"Logging": UNCALLED},
}

# JAX modules with no module of the same path in the port
MODULE_MOVED = {"ops/pallas_fast.py": "ops/fast.py"}
MODULE_NOT_PORTED = {
    "tools/__init__.py": "tools/ is not ported: each tool's counterpart is named beside it",
    "tools/tpu_smoke.py": "chip_smoke.py is the port's smoke run",
    "tools/microprofile.py": "profile_slice.py replaces it",
    "tools/convert_checkpoint.py": FLAX_CONVERTER,
}


def _jax_modules():
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), JAX_PKG)


def test_visual_odometry_educational_is_an_alias():
    from pyslam_tpu_torch.slam.visual_odometry import (VisualOdometry,
                                                       VisualOdometryEducational)

    assert VisualOdometryEducational is VisualOdometry


@pytest.mark.parametrize("module", sorted(_jax_modules()))
def test_every_public_name_has_a_counterpart(module):
    """Every public top-level name of the JAX module is bound at the top
    level of the port's module of the same path (or of ``MODULE_MOVED``'s),
    or is kept elsewhere (``MOVED``, checked to exist), or has no
    counterpart for the reason ``NOT_PORTED`` gives."""
    if module in MODULE_NOT_PORTED:
        assert not os.path.exists(os.path.join(PKG, module)), module
        return
    port_module = MODULE_MOVED.get(module, module)
    have, _ = _top_level(os.path.join(PKG, port_module), with_imports=True)
    names, _ = _top_level(os.path.join(JAX_PKG, module))
    missing = []
    for name in sorted(n for n in names if not n.startswith("_")):
        if name in have or name in NOT_PORTED.get(module, {}):
            continue
        target = MOVED.get((module, name))
        if target is None:
            missing.append(name)
            continue
        path, qual = target.split("::")
        top, members = _top_level(os.path.join(PKG, path), with_imports=True)
        cls, _, member = qual.partition(".")
        assert cls in top and (not member or member in members.get(cls, ())), target
    assert not missing, f"{module}: {missing} have no counterpart in the port"
    for name in NOT_PORTED.get(module, {}):
        assert name in names and name not in have, (module, name)


def test_import_builds_nothing():
    """Importing the package must not compile or load the CUDA kernels, nor
    the native observation graph (built at the first ``Map``)."""
    import pyslam_tpu_torch  # noqa: F401
    from pyslam_tpu_torch import _build

    assert _build._lib is None
    code = ("import pyslam_tpu_torch, pyslam_tpu_torch.slam.slam, pyslam_tpu_torch.pipeline\n"
            "import pyslam_tpu_torch.parallel.sharded_ba, pyslam_tpu_torch.evaluation.manager\n"
            "from pyslam_tpu_torch import native\n"
            "assert native._lib is None and native.build_seconds is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_native_source_is_the_ports_own():
    """The native library is built from the port's own copy of the C++
    source, and no module of the port names a path into the JAX package."""
    from pyslam_tpu_torch import native

    assert os.path.dirname(native.SOURCE) == os.path.join(PKG, "native")
    assert os.path.exists(native.SOURCE)
    assert native.library_path().startswith(os.path.join(PKG, "_build") + os.sep)
    own = os.path.join(PKG, "native", "__init__.py")
    for path in _py_files():
        tree = ast.parse(open(path).read(), path)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert "pyslam_tpu/native" not in node.value, path
                assert "obs_graph" not in node.value or path == own, path


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
                                  "features.matcher.LightGlueFeatureMatcher",
                                  "models.vggt.VGGTModel", "models.fast3r.Fast3RModel",
                                  "scene_from_views.scene_from_views.scene_from_views_factory",
                                  "scene_from_views.scene_from_views.SceneFromViewsBase",
                                  "dense.gaussian_splatting_integrator.GaussianSplattingVolume",
                                  "parallel.mesh.make_mesh",
                                  "parallel.sharded_ba.bundle_adjust_sharded",
                                  "pipeline.frontend_step",
                                  "evaluation.manager.SlamEvaluationManager.run_distributed"])
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
