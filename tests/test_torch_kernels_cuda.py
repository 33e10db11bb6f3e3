"""The hand-written CUDA kernel against its plain PyTorch version, and the
dense slice's plain PyTorch ops (SGM, the TSDF update) against their CPU
run, on the card.  Marked ``cuda``: these tests need a GPU and skip
without one (a skip counts as no pass).  Run them on the card, where JAX
(which ``tests/conftest.py`` imports) need not be installed, from the
repository's root with
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from pyslam_tpu_torch.ops.fast import fast_nms, fast_nms_plain
# a top-level import: pytest puts this directory on sys.path, while the name
# ``tests`` may belong to another installed package
from torch_parity import rng, synth_image

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("hw", [(376, 1241), (105, 346), (150, 200), (33, 40)])
def test_fast_nms_kernel_equals_plain(cuda, hw):
    r = rng(hw[0])
    imgs = np.stack([synth_image(r, *hw, n_blobs=max(1, hw[0] // 8)) if hw[0] > 60
                     else r.uniform(0, 255, hw).astype(np.float32) for _ in range(2)])
    x = torch.as_tensor(imgs).to(cuda)
    before = fast_nms.launches
    got = fast_nms(x, 20.0)
    ref = fast_nms_plain(x, 20.0)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert fast_nms.launches == before + 1


def test_fast_nms_kernel_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        fast_nms(torch.zeros((2, 64, 64), dtype=torch.float64, device=cuda), 20.0)
    with pytest.raises(ValueError):
        fast_nms(torch.zeros((2, 64, 64), device=cuda).transpose(1, 2), 20.0)


def test_fast_nms_pyramid_one_launch_equals_plain(cuda):
    """All 8 levels of a 376x1241 stereo pair in one launch, each level
    identical to the plain version."""
    from pyslam_tpu_torch.ops.fast import fast_nms_pyramid
    from pyslam_tpu_torch.ops.image import build_pyramid

    r = rng(11)
    pair = np.stack([synth_image(r, 376, 1241, n_blobs=80) for _ in range(2)])
    levels = build_pyramid(torch.as_tensor(pair).to(cuda), 8, 1.2)
    before = fast_nms.launches
    got = fast_nms_pyramid(levels, 20.0)
    torch.cuda.synchronize()
    assert fast_nms.launches == before + 1
    for lv, (x, y) in enumerate(zip(levels, got)):
        assert torch.equal(y, fast_nms_plain(x.contiguous(), 20.0)), lv


def _kitti_pair():
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset, SyntheticWorld

    world = SyntheticWorld(n_points=16000, extent=60.0, depth_range=(4.0, 80.0))
    ds = SyntheticDataset(num_frames=1, h=376, w=1241, fx=718.856, baseline=0.54,
                          trajectory="line", step=0.8, sensor_type=SensorType.STEREO,
                          world=world)
    return ds, ds.getImage(0), ds.getImageRight(0)


def test_sgm_depth_card_equals_cpu(cuda):
    """The integrator's SGM (downscale 2: 188x620, 32 disparities) on a
    376x1241 pair: disparity and depth identical on the card and the CPU
    (integer-valued float32 up to one true division)."""
    from pyslam_tpu_torch.depth_estimation.depth_estimator import DepthEstimatorSgbm
    from pyslam_tpu_torch.slam.camera import PinholeCamera

    ds, left, right = _kitti_pair()
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, bf=ds.fx * ds.baseline)
    got = DepthEstimatorSgbm(cam, downscale=2, device=cuda)
    ref = DepthEstimatorSgbm(cam, downscale=2, device="cpu")
    disp = got._disparity_full_scale(left, right)
    assert disp.device.type == "cuda"
    assert torch.equal(disp.cpu(), ref._disparity_full_scale(left, right))
    depth = got.infer_depth_device(left, right)
    assert torch.equal(depth.cpu(), ref.infer_depth_device(left, right))
    assert float((depth > 0).float().mean()) > 0.2


def test_tsdf_update_card_equals_cpu(cuda):
    """One keyframe's 3 TSDF phases into a 1 << 22 table: the updates are
    bit-equal, the slots, keys and occupied identical; tsdf, weight and
    color agree within 1e-5 relative (the card's scatter-add sums in no
    fixed order)."""
    from pyslam_tpu_torch.dense.tsdf import TSDFVolume

    r = rng(3)
    depth = r.uniform(4.0, 60.0, (376, 1241)).astype(np.float32)
    inten = r.uniform(0, 255, (376, 1241)).astype(np.float32)
    K = np.array([[718.856, 0, 620.5], [0, 718.856, 187.5], [0, 0, 1]])
    Twc = np.eye(4)
    Twc[:3, 3] = [0.3, -0.1, 2.0]
    vols = [TSDFVolume(voxel_size=0.2, sdf_trunc=0.6, depth_trunc=40.0, capacity=1 << 22,
                       device=d) for d in (cuda, "cpu")]
    for phase in range(3):
        for v in vols:
            v.integrate(depth, inten, Twc, K, phase=phase, phases=3)
    got, ref = vols[0].table, vols[1].table
    for f in ("keys", "occupied"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f)), f
    for f in ("tsdf", "weight", "color"):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(ref, f), rtol=1e-5, atol=1e-6)
    assert vols[0].stride == 3 and vols[0].band_steps == 2
    assert vols[0].num_voxels() > 10000
