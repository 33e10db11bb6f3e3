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


def test_fast_nms_one_image_pyramid_and_vo_level(cuda):
    """The kernel as the monocular and RGBD paths call it: the B = 1 pyramid
    of one 376x1241 image at threshold 20 in one launch, and the RGBD VO's
    one level at threshold 15, bit for bit against the plain version."""
    from pyslam_tpu_torch.ops import image as image_ops
    from pyslam_tpu_torch.ops.fast import fast_nms_pyramid

    img = torch.as_tensor(synth_image(rng(5), 376, 1241, n_blobs=120))[None].to(cuda)
    levels = [x.contiguous() for x in image_ops.build_pyramid(img, 8, 1.2)]
    before = fast_nms.launches
    got = fast_nms_pyramid(levels, 20.0)
    one = fast_nms(img, 15.0)
    torch.cuda.synchronize()
    assert fast_nms.launches == before + 2
    for g, x in zip(got, levels):
        assert torch.equal(g, fast_nms_plain(x, 20.0))
    assert torch.equal(one, fast_nms_plain(img, 15.0))


def test_rgbd_virtual_right_and_lk_card_equal_cpu(cuda):
    """compute_stereo_from_rgbd identical on the card and the CPU; LK within
    1e-2 px where both say ok."""
    from pyslam_tpu_torch.ops import lk
    from pyslam_tpu_torch.slam.frame import compute_stereo_from_rgbd

    r = rng(6)
    img0 = synth_image(r, 240, 320)
    img1 = np.ascontiguousarray(np.roll(img0, (2, -3), (0, 1)))
    kps = np.c_[r.uniform(0, 320, 600), r.uniform(0, 240, 600)].astype(np.float32)
    depth = r.uniform(0.0, 30.0, (240, 320)).astype(np.float32)
    valid = r.random(600) < 0.9
    args = [torch.as_tensor(kps), torch.as_tensor(kps + 0.3), torch.as_tensor(valid),
            torch.as_tensor(depth)]
    got = compute_stereo_from_rgbd(*[a.to(cuda) for a in args], 75.0, 0.1)
    ref = compute_stereo_from_rgbd(*args, 75.0, 0.1)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    pts = torch.as_tensor(kps[:256] * 0.8 + 20.0)
    p_g, ok_g, _ = lk.lk_track_pyramidal(torch.as_tensor(img0).to(cuda),
                                         torch.as_tensor(img1).to(cuda), pts.to(cuda))
    p_c, ok_c, _ = lk.lk_track_pyramidal(torch.as_tensor(img0), torch.as_tensor(img1), pts)
    both = ok_g.cpu() & ok_c
    assert both.sum() > 50
    assert float((p_g.cpu()[both] - p_c[both]).abs().max()) <= 1e-2
