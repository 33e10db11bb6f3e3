"""Carry state across between the JAX package and the port.

``map_from_tpu_json`` builds the port's ``Map`` from the dict that
``pyslam_tpu.slam.map_serialization.map_to_json`` writes (format
``pyslam_tpu_map_v1``: base64 numpy blocks, bit-packed descriptors) through
the port's reader of that schema (``slam/map_serialization.py``, whose
``map_to_json`` writes maps the JAX package's ``map_from_json`` reads), so
that either package can continue from the other's map.
``voxel_table_from_numpy`` builds the dense state, the voxel-hash table,
from the arrays of the JAX package's table (``TSDFVolume.load`` reads its
``.npz`` through it).

The learned models' weights: ``superpoint_state_dict``,
``lightglue_state_dict``, ``resnet_state_dict`` and
``cosplace_state_dict`` take the JAX package's flat parameters (the
``params/...`` keys of its ``.npz`` checkpoints, numpy arrays) and return
the port's ``state_dict``: a flax convolution kernel (kh, kw, I, O) becomes
(O, I, kh, kw), a Dense kernel (in, out) an ``nn.Linear`` weight (out,
in), a LayerNorm ``scale`` its ``weight``; batch-norm statistics,
``rotary_w`` and ``gem_p`` keep their values.  ``bundled_checkpoint``
finds the JAX package's bundled checkpoints by path (a data file, not an
import); ``seeded_init_`` draws the random weights a model falls back to
without one.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from pyslam_tpu_torch.ops.voxel_hash import VoxelHashTable
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.slam.map_serialization import map_from_json


def map_from_tpu_json(d: dict, camera, feature_tracker) -> Map:
    """Port ``Map`` on ``feature_tracker.device`` from a native-schema dict
    (``slam.map_serialization.map_from_json``, the one reader)."""
    return map_from_json(d, feature_tracker, camera)


def voxel_table_from_numpy(keys, occupied, tsdf, weight, color, *,
                           device: torch.device | str = "cuda") -> VoxelHashTable:
    """The port's voxel-hash table on ``device`` from the five arrays of a
    ``pyslam_tpu.ops.voxel_hash.VoxelHashTable`` (keys (C,3) int32,
    occupied (C,), tsdf (C,), weight (C,), color (C,3)); the slots keep
    their places, so lookups and later inserts resolve as in the JAX
    package."""
    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)   # a copy of its own

    keys = put(keys, np.int32)
    if keys.ndim != 2 or keys.shape[1] != 3 or keys.shape[0] & (keys.shape[0] - 1):
        raise ValueError(f"keys must be (C,3) with C a power of two, got {tuple(keys.shape)}")
    return VoxelHashTable(keys=keys, occupied=put(occupied, bool), tsdf=put(tsdf, np.float32),
                          weight=put(weight, np.float32), color=put(color, np.float32))


CHECKPOINT_DIR = Path(__file__).resolve().parent.parent / "pyslam_tpu" / "models" / "checkpoints"

# the MagicLeap names of SuperPoint's convolutions, in the call order that
# names them Conv_0..Conv_11 in flax (encoder, detector head, descriptor head)
SUPERPOINT_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
                    "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb")


def bundled_checkpoint(name: str) -> str | None:
    """Path of the JAX package's bundled ``{name}.npz``, or None when the
    file is not there."""
    p = CHECKPOINT_DIR / f"{name}.npz"
    return str(p) if p.exists() else None


def read_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _leaf(kind: str, v: np.ndarray) -> torch.Tensor:
    v = np.asarray(v, np.float32)
    if kind == "kernel":
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
    return torch.from_numpy(np.ascontiguousarray(v))


def _convert(flat: dict, module_name) -> dict[str, torch.Tensor]:
    """state_dict from the ``params/`` leaves of ``flat``: ``module_name``
    maps a flax module path (tuple of names) to the torch module's dotted
    name; ``kernel`` and ``scale`` become ``weight``."""
    out = {}
    for key, v in flat.items():
        if not key.startswith("params/"):
            continue
        *path, leaf = key[len("params/"):].split("/")
        mod = module_name(tuple(path))
        name = "weight" if leaf in ("kernel", "scale") else leaf
        out[f"{mod}.{name}" if mod else name] = _leaf(leaf, v)
    return out


def superpoint_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``SuperPointNet`` weights from flax ``Conv_0..Conv_11``."""
    return _convert(flat, lambda p: SUPERPOINT_CONVS[int(p[0].split("_")[1])])


def lightglue_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``LightGlueNet`` weights: its modules carry the flax names."""
    return _convert(flat, ".".join)


def _resnet_module(path: tuple) -> str:
    out = []
    for part in path:
        if part.startswith("layer") and "_" in part:
            out.append(part.replace("_", "."))       # layer2_0 -> layer2.0
        else:
            out.append({"downsample_conv": "downsample.0",
                        "downsample_bn": "downsample.1"}.get(part, part))
    return ".".join(out)


def resnet_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``ResNet`` weights (torchvision names) from a flax ``ResNet`` tree."""
    return _convert(flat, _resnet_module)


def cosplace_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``GeoLocalizationNet`` weights: ``backbone``, ``gem_p`` and ``fc``."""
    return _convert(flat, _resnet_module)


def seeded_init_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random weights from a ``torch.Generator`` seeded ``seed``: every
    parameter of two or more dimensions from N(0, 1 / fan_in), biases zero,
    the other vectors (norm scales, ``gem_p``) as constructed."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
            elif name.endswith("bias"):
                p.zero_()
    return module
