"""Row padding to shape buckets (host copy of ``pad_bucket`` and
``pad_rows`` of ``pyslam_tpu/utils/padding.py``, with its CPU policy:
power-of-two buckets from 64 rows).

The loop-closing and relocalisation calls pad their variable-length
correspondence sets so that a call's tensors keep a handful of shapes over
a session, with a validity mask for the padded rows.
"""

from __future__ import annotations

import numpy as np


def bucket_size(n: int, minimum: int = 64) -> int:
    """Next power of two >= n (>= minimum)."""
    if n <= minimum:
        return minimum
    return 1 << int(np.ceil(np.log2(n)))


def pad_rows(arr: np.ndarray, n_to: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``arr`` to length ``n_to`` with ``fill``."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n == n_to:
        return arr
    pad_shape = (n_to - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)


def pad_bucket(arr: np.ndarray, fill=0, minimum: int = 64):
    """Pad axis 0 to its bucket; returns (padded, valid mask)."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    m = bucket_size(n, minimum)
    valid = np.zeros((m,), bool)
    valid[:n] = True
    return pad_rows(arr, m, fill), valid
