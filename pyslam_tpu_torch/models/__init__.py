"""Learned perception models (port of ``pyslam_tpu/models/``): SuperPoint,
LightGlue, the ResNet trunk and CosPlace / EigenPlaces, the learned
local features XFeat, DISK, ALIKED, R2D2, D2-Net, Key.Net, LF-Net, DELF,
the patch descriptors (HardNet, SOSNet, L2Net, TFeat, GeoDesc, the
log-polar net) and ContextDesc, the dense two-view matchers LoFTR and
DUSt3R / MASt3R, the place-recognition networks NetVLAD and MegaLoc
(over ``depth_anything_v2``'s ViT block), and the depth models: the
DPT-lite, DepthAnythingV2, DepthAnything 3 and DepthPro (over VGGT's block,
``vggt._Block``), RAFT-Stereo, CREStereo and MV-DUSt3R.

Each family is an ``nn.Module`` in plain PyTorch (``F.conv2d``, matrix
products, softmax, index gathers; ALIKED's deformable convolutions are
gathers followed by one product, with the reference's own boundary rule)
on an explicit device, float32 with TF32 off (the package's precision
policy).  The JAX package's models reach no Pallas kernel: their
convolutions, gathers and attention products are XLA ops, and here they are
cuDNN convolutions, gathers and ``torch.matmul``.  ``layers`` holds what
the local-feature modules share (flax "SAME" padding, the JAX package's
bilinear resize, flax LayerNorm and SELU).

Weights: the bundled checkpoints of the JAX package
(``pyslam_tpu/models/checkpoints/{superpoint,lightglue,cosplace}_tiny.npz``)
are read by path and carried across by ``pyslam_tpu_torch.interop``; an
official torch checkpoint loads through ``models.torch_convert`` (a key
mapping: the modules keep the official state-dict layouts where there is
one).  No other family has a bundled checkpoint: XFeat, DISK, ALIKED,
R2D2, D2-Net, Key.Net, LF-Net, DELF, the patch descriptors, ContextDesc,
LoFTR, DUSt3R / MASt3R, NetVLAD, MegaLoc, the depth models (and LightGlue
on 64- or 128-d descriptors) run with random weights
from a seeded ``torch.Generator`` and report ``trained = False`` until an
official checkpoint (or the JAX package's ``.npz`` for the TF1-era LF-Net,
DELF, GeoDesc and ContextDesc) is given.  The JAX package draws its random
weights from ``PRNGKey(0)``: other numbers, so the tests carry its weights
across before they compare.
"""
