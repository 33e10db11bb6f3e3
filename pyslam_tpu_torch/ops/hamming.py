"""Descriptor distances (port of ``pyslam_tpu/ops/hamming.py``).

Binary descriptors are unpacked 0/1 bit-planes, so an all-pairs Hamming
matrix is one matrix product:  hamming(a, b) = |a| + |b| - 2 a.b.  PyTorch
has no int8 matmul on CUDA, so the product runs in float32: products and
sums of 0/1 values up to 2^24 are exact there (TF32 is off, see the package
policy), and the result equals the reference's integers for the 256-, 486-
and 512-bit layouts alike.  Float descriptors (SIFT, SURF, KAZE) take the
L2 matrix, one float32 product plus the squared norms.
``descriptor_distance_matrix`` dispatches on the dtype, as the reference
does; packing to uint8 bytes exists only at the serialisation boundary.
"""

from __future__ import annotations

import numpy as np
import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., B) uint8 packed descriptors -> (..., 8B) int8 bit-planes, MSB
    first as ``np.unpackbits``."""
    bits = (packed[..., :, None] >> _shifts(packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., D) 0/1 bits -> (..., D // 8) uint8 packed, MSB first."""
    d = bits.shape[-1]
    b = bits.reshape(*bits.shape[:-1], d // 8, 8).to(torch.uint8)
    return (b << _shifts(bits.device)).sum(-1).to(torch.uint8)


def hamming_distance_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(N, D) and (M, D) 0/1 bits -> (N, M) float32 distances (exact
    integers).  Leading batch dimensions broadcast."""
    a = bits_a.to(torch.float32)
    b = bits_b.to(torch.float32)
    dot = a @ b.transpose(-1, -2)
    pop_a = a.sum(-1)
    pop_b = b.sum(-1)
    return pop_a[..., :, None] + pop_b[..., None, :] - 2.0 * dot


def l2_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs L2 distances of float descriptors, (N, D) x (M, D) ->
    (N, M) float32: sqrt(max(|a|^2 + |b|^2 - 2 a.b, 0)).  Leading batch
    dimensions broadcast."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    dot = a @ b.transpose(-1, -2)
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    d2 = torch.clamp(na[..., :, None] + nb[..., None, :] - 2.0 * dot, min=0.0)
    return torch.sqrt(d2)


def hamming_distance_matrix_packed(packed_a: torch.Tensor,
                                   packed_b: torch.Tensor) -> torch.Tensor:
    """Packed uint8 descriptors -> Hamming distance matrix."""
    return hamming_distance_matrix(unpack_bits(packed_a), unpack_bits(packed_b))


def np_pack(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), axis=-1)


def np_unpack(packed: np.ndarray) -> np.ndarray:
    return np.unpackbits(packed, axis=-1).astype(np.int8)


def descriptor_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs descriptor distance, float32: L2 for float descriptors,
    Hamming for integer bit-planes (the reference's dtype dispatch)."""
    if a.is_floating_point():
        return l2_distance_matrix(a, b)
    return hamming_distance_matrix(a, b)
