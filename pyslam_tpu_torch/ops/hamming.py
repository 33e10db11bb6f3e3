"""Binary-descriptor Hamming distances (port of ``pyslam_tpu/ops/hamming.py``).

Descriptors are unpacked 0/1 bit-planes, so an all-pairs distance matrix is
one matrix product:  hamming(a, b) = |a| + |b| - 2 a.b.  PyTorch has no int8
matmul on CUDA, so the product runs in float32: products and sums of 0/1
values up to 256 are exact there (TF32 is off, see the package policy), and
the result equals the reference's integers.
"""

from __future__ import annotations

import torch


def hamming_distance_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(N, D) and (M, D) 0/1 bits -> (N, M) float32 distances (exact
    integers).  Leading batch dimensions broadcast."""
    a = bits_a.to(torch.float32)
    b = bits_b.to(torch.float32)
    dot = a @ b.transpose(-1, -2)
    pop_a = a.sum(-1)
    pop_b = b.sum(-1)
    return pop_a[..., :, None] + pop_b[..., None, :] - 2.0 * dot

