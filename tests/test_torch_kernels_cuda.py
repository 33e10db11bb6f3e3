"""The hand-written CUDA kernel against its plain PyTorch version, on the
card.  Marked ``cuda``: these tests need a GPU and skip without one (a skip
counts as no pass).  Run them on the card with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from pyslam_tpu_torch.ops.fast import fast_nms, fast_nms_plain
from tests.torch_parity import rng, synth_image

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
