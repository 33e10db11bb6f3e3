"""pyslam_tpu_torch — the PyTorch/CUDA port of ``pyslam_tpu``.

A second package beside the JAX reference, with the same layout and module
names (``ops/``, ``features/``, ``slam/``, ``io/``, ``evaluation/``,
``utils/``).  It imports ``torch`` and numpy, never ``jax`` or
``pyslam_tpu``.  Plain tensor code is PyTorch; the one Pallas kernel of the
reference (FAST-9 + 3x3 NMS) is a hand-written CUDA kernel under ``csrc/``,
built at its first CUDA call (``_build.py``), never at import.

Precision policy: float32 everywhere, and no TF32 — neither in matrix
products nor in cuDNN convolutions (the latter is on by default).
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
