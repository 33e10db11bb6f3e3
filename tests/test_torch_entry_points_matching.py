"""``main_feature_matching`` of the port on the CPU against the JAX
package's on the synthetic pair, and its refusals (split from
tests/test_torch_entry_points.py, so that the xdist workers share the
entry points' time; its autouse fixture restores the Parameters flags
here too)."""

import numpy as np
import pytest
from PIL import Image

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)

from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from tests.test_torch_entry_points import _restore_parameters  # noqa: F401  (autouse fixture)
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)


def _printed(capsys, run):
    capsys.readouterr()
    assert run() == 0
    return [line.strip() for line in capsys.readouterr().out.splitlines() if line.strip()]


def test_main_feature_matching(capsys, tmp_path):
    """``main_feature_matching`` on the synthetic frames 0 and 2 (ORB2, 1000
    features, 4 levels) prints what the JAX package's prints: the same
    keypoint counts, the match count within 2 % and the median displacement
    within 0.5 px (measured 232 against 234 matches, 0.19 px: the two
    packages' ORB2 keypoints part at near-ties of the 1000-slot cut, and
    the port's matcher on the JAX package's features makes its 234); on
    two PNG files with a preset (AKAZE) it matches them."""
    import jax

    import main_feature_matching as ref
    from pyslam_tpu_torch import main_feature_matching

    with jax.enable_x64(False):
        want = _printed(capsys, lambda: _ref_main(ref, []))
    got = _printed(capsys, lambda: main_feature_matching.main(["--device", "cpu"]))
    assert got[0] == want[0] and got[1].startswith("matches: ") and len(got) == len(want) == 3
    n, n_ref = int(got[1].split()[1]), int(want[1].split()[1])
    assert n_ref > 50 and abs(n - n_ref) <= 0.02 * n_ref, (got, want)

    def median(line):
        return np.array(line.split("[")[1].rstrip("]").split(), float)

    assert np.abs(median(got[2]) - median(want[2])).max() <= 0.5, (got, want)
    ds = SyntheticDataset(num_frames=3, sensor_type=SensorType.MONOCULAR)
    paths = []
    for i in (0, 2):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(np.clip(ds.getImage(i), 0, 255).astype(np.uint8)).save(paths[-1])
    out = _printed(capsys, lambda: main_feature_matching.main(
        ["--img1", paths[0], "--img2", paths[1], "--features", "AKAZE", "--device", "cpu"]))
    assert int(out[1].split()[1]) > 0


def _ref_main(ref, argv):
    import sys

    saved = sys.argv
    sys.argv = ["main_feature_matching.py"] + argv
    try:
        return ref.main()
    finally:
        sys.argv = saved


def test_main_feature_matching_refuses_loftr_and_needs_the_card(capsys):
    """LOFTR has no per-image extraction (its ``detectAndCompute`` raises,
    as the reference tracker's); without a card the default device is an
    error, never a run on the CPU."""
    import torch

    from pyslam_tpu_torch import main_feature_matching

    with pytest.raises(NotImplementedError, match="detector-free"):
        main_feature_matching.main(["--features", "LOFTR", "--device", "cpu"])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as e:
        main_feature_matching.main([])
    assert e.value.code == 2 and "no CUDA device" in capsys.readouterr().err
