"""Official torch checkpoints -> the port's state dicts (port of the
SuperPoint, LightGlue, ResNet and CosPlace parts of
``pyslam_tpu/models/torch_convert.py``, ``resnet.py:154-192`` and
``cosplace.py:57-101``).

The port's modules keep the official layouts, so each conversion is a key
mapping, not a layout change: MagicLeap's ``conv1a..convDb`` and
LightGlue-class checkpoints named like the flax tree (dots for slashes,
``generic_from_torch``'s convention) load as ``load_torch_file`` reads
them, a torchvision ResNet loses its head and ``num_batches_tracked``, and a
CosPlace / EigenPlaces hub checkpoint has its Sequential backbone renamed
and its GeM ``p`` and linear head found by shape.  Nothing is downloaded:
the caller names the file.
"""

from __future__ import annotations

import torch


def load_torch_file(path: str) -> dict[str, torch.Tensor]:
    """The state dict of a ``.pth`` / ``.pt`` file (unwrapping a
    ``state_dict`` or ``model_state_dict`` entry and a ``module.``
    prefix), on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model_state_dict"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def resnet_from_torch(state_dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """A torchvision resnet state dict (under ``prefix``, e.g.
    ``backbone.``) -> ``ResNet`` weights; fc and ``num_batches_tracked``
    are dropped."""
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix) and not k[len(prefix):].startswith("fc.")
            and not k.endswith("num_batches_tracked")}


_SEQUENTIAL_BACKBONE = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                        "6": "layer3", "7": "layer4"}


def cosplace_from_torch(state_dict):
    """A CosPlace / EigenPlaces hub checkpoint -> (``GeoLocalizationNet``
    weights, arch, out_dim); arch and out_dim are read from the shapes."""
    sd = dict(state_dict)
    if not any(k.startswith("backbone.conv1") for k in sd):
        # CosPlace stores the trunk as a bare Sequential: backbone.N.
        out = {}
        for k, v in sd.items():
            parts = k.split(".")
            if parts[0] == "backbone" and parts[1] in _SEQUENTIAL_BACKBONE:
                parts[1] = _SEQUENTIAL_BACKBONE[parts[1]]
            out[".".join(parts)] = v
        sd = out
    # GeM's p is the one ``.p`` tensor; the linear head the one 2-D weight
    p_key = next(k for k in sd if k.endswith(".p") or k == "gem.p")
    fc_w = next(k for k in sd if sd[k].ndim == 2 and k.endswith("weight"))
    out_dim, feat_dim = sd[fc_w].shape
    n_l3 = len({k.split(".")[2] for k in sd if k.startswith("backbone.layer3.")})
    if feat_dim == 512:
        arch = "resnet18" if n_l3 <= 2 else "resnet34"
    else:
        arch = "resnet50" if n_l3 <= 6 else "resnet101"
    weights = {f"backbone.{k}": v for k, v in resnet_from_torch(sd, "backbone.").items()}
    weights["gem_p"] = sd[p_key].reshape(1)
    weights["fc.weight"] = sd[fc_w]
    weights["fc.bias"] = sd[fc_w[:-len("weight")] + "bias"]
    return weights, arch, int(out_dim)
