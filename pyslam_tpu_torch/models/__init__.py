"""Learned perception models that ship weights (port of the SuperPoint,
LightGlue, ResNet and CosPlace/EigenPlaces modules of
``pyslam_tpu/models/``).

Each family is an ``nn.Module`` in plain PyTorch (``F.conv2d``, matrix
products, softmax) on an explicit device, float32 with TF32 off (the
package's precision policy).  The JAX package's models reach no Pallas
kernel: their convolutions and attention products are XLA ops, and here they
are cuDNN convolutions and ``torch.matmul``.

Weights: the bundled checkpoints of the JAX package
(``pyslam_tpu/models/checkpoints/{superpoint,lightglue,cosplace}_tiny.npz``)
are read by path and carried across by ``pyslam_tpu_torch.interop``; an
official torch checkpoint loads through ``models.torch_convert`` (a key
mapping: the modules keep the official state-dict layouts).  Without a
checkpoint a model draws random weights from a seeded ``torch.Generator``
and reports ``trained = False``.
"""
