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
                                  "interop.voxel_table_from_numpy"])
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
