"""Official torch checkpoints -> the port's state dicts (port of
``pyslam_tpu/models/torch_convert.py``, ``resnet.py:154-192``,
``cosplace.py:57-101`` and the ``*_from_torch`` converters of the learned
local-feature modules: ``patch_descriptors.py:200-290``, ``disk.py:79``,
``aliked.py:227``, ``r2d2.py:96``, ``d2net.py:61``, ``keynet.py:97``, and
of the dense matchers and VPR networks: ``loftr.py:281``,
``torch_convert.py:225-329``).

The port's modules keep the official layouts, so each conversion is a key
mapping, not a layout change: MagicLeap's ``conv1a..convDb`` and
LightGlue-class checkpoints named like the flax tree (dots for slashes,
``generic_from_torch``'s convention) load as ``load_torch_file`` reads
them, a torchvision ResNet loses its head and ``num_batches_tracked``, and a
CosPlace / EigenPlaces hub checkpoint has its Sequential backbone renamed
and its GeM ``p`` and linear head found by shape.  XFeat, ALIKED and R2D2
load with their own keys; the L2Net-class patch nets, TFeat, DISK and
Key.Net are mapped by the order of their layers, as the JAX package maps
them, and D2-Net loses its module prefix.  LoFTR, DUSt3R / MASt3R and
NetVLAD keep their official names.  Nothing is downloaded:
the caller names the file.
"""

from __future__ import annotations

import torch


def load_torch_file(path: str, *wrappers: str) -> dict[str, torch.Tensor]:
    """The state dict of a ``.pth`` / ``.pt`` file (unwrapping a
    ``state_dict`` or ``model_state_dict`` entry, then any of
    ``wrappers``, and a ``module.`` prefix), on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in wrappers + ("state_dict", "model_state_dict"):
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


# ------------------------------------------------- learned local features
def _plain(state_dict, drop=()) -> dict[str, torch.Tensor]:
    """The entries of an official state dict whose layout the port keeps:
    without batch counters and the prefixes in ``drop``."""
    return {k: v for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked") and not k.startswith(drop)}


def _l2net_backbone(sd, prefix: str) -> dict[str, torch.Tensor]:
    """An L2Net-class backbone (7 convs, each followed by its BN, under
    ``prefix``, at any Sequential indices) -> the port's ``features``."""
    from pyslam_tpu_torch.interop import HARDNET_CONV_IDX

    convs = sorted({int(k.split(".")[1]) for k, v in sd.items()
                    if k.startswith(prefix + ".") and k.endswith(".weight") and v.ndim == 4})
    if len(convs) != len(HARDNET_CONV_IDX):
        raise KeyError(f"expected {len(HARDNET_CONV_IDX)} convolutions under {prefix}., "
                       f"found {len(convs)}")
    out = {}
    for src, dst in zip(convs, HARDNET_CONV_IDX):
        for off in (0, 1):                         # the conv, then its BN
            pre = f"{prefix}.{src + off}."
            for k, v in sd.items():
                if k.startswith(pre) and not k.endswith("num_batches_tracked"):
                    out[f"features.{dst + off}.{k[len(pre):]}"] = v
    return out


def hardnet_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """HardNet's, L2Net's or the log-polar net's ``features`` Sequential."""
    return _l2net_backbone(state_dict, "features")


def sosnet_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """Official SOSNet checkpoints name the Sequential ``layers``."""
    prefix = "layers" if any(k.startswith("layers.") for k in state_dict) else "features"
    return _l2net_backbone(state_dict, prefix)


def tfeat_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """tfeat TNet: its two convolutions and its linear layer, found by
    shape."""
    sd = state_dict
    convs = sorted((k for k in sd if k.endswith(".weight") and sd[k].ndim == 4),
                   key=lambda k: int(k.split(".")[1]))
    fc = next(k for k in sd if k.endswith(".weight") and sd[k].ndim == 2)
    out = {}
    for src, dst in zip(convs + [fc], ("features.1", "features.4", "classifier.0")):
        out[f"{dst}.weight"] = sd[src]
        out[f"{dst}.bias"] = sd[src[: -len("weight")] + "bias"]
    return out


def xfeat_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """The public XFeatModel: the port keeps its names; the match
    refinement MLP (``fine_matcher``) is not used for extraction."""
    return _plain(state_dict, ("fine_matcher.",))


def aliked_from_torch(state_dict) -> dict[str, torch.Tensor]:
    return _plain(state_dict)


def r2d2_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """Quad_L2Net_ConfCFS: the official ``ops.N`` list, ``clf``, ``sal``."""
    return _plain(state_dict)


def d2net_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """D2-Net's named VGG convolutions, without their module prefix."""
    out = {}
    for k, v in state_dict.items():
        k = k.replace("dense_feature_extraction.model.", "")
        out[k[len("model."):] if k.startswith("model.") else k] = v
    return out


def disk_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """By registration order, as the JAX package maps it: the convolutions
    (down path, then up path) and the PReLU slopes of every block but the
    last (a single slope is broadcast to the channels)."""
    from pyslam_tpu_torch.models.disk import DOWN, UP

    sizes = {1, *DOWN, *UP}
    convs = [k for k, v in state_dict.items() if v.ndim == 4]
    slopes = [v for k, v in state_dict.items()
              if v.ndim <= 1 and "bias" not in k and v.numel() in sizes]
    names = [f"down{i}" for i in range(len(DOWN))] + [f"up{i}" for i in range(len(UP))]
    out = {}
    for i, (name, k) in enumerate(zip(names, convs)):
        out[f"{name}.conv.weight"] = state_dict[k]
        out[f"{name}.conv.bias"] = state_dict[k[: -len("weight")] + "bias"]
        if i < len(names) - 1:
            ch = state_dict[k].shape[0]
            out[f"{name}.prelu"] = (slopes[i].reshape(-1).expand(ch).clone() if i < len(slopes)
                                    else torch.full((ch,), 0.25))
    return out


def keynet_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """Key.Net (kornia / official) by order: the three 3x3 convolutions,
    the batch norms of their 8 channels in order, the 1x1 last conv."""
    sd = state_dict
    convs = [k for k in sd if k.endswith(".weight") and sd[k].ndim == 4]
    body = [k for k in convs if sd[k].shape[2] == 3][:3]
    last = next(k for k in convs if sd[k].shape[2] == 1)
    out = {}
    for i, k in enumerate(body):
        out[f"learnable.conv{i}.weight"] = sd[k]
        ch = sd[k].shape[0]
        mean = [b for b in sd if b.endswith("running_mean") and sd[b].shape[0] == ch][i]
        base = mean[: -len("running_mean")]
        for leaf in ("running_mean", "running_var", "weight", "bias"):
            out[f"learnable.bn{i}.{leaf}"] = sd[base + leaf]
    out["last_conv.weight"] = sd[last]
    out["last_conv.bias"] = sd[last[: -len("weight")] + "bias"]
    return out


# ------------------------------------------- dense matchers and VPR networks
def loftr_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """An official LoFTR checkpoint (``matcher.`` prefix optional) ->
    ``LoFTRNet`` weights: the port keeps the official names; the position
    encoding's buffer and the batch counters are dropped."""
    sd = {k[len("matcher."):] if k.startswith("matcher.") else k: v
          for k, v in state_dict.items()}
    return _plain(sd, ("pos_encoding.",))


def dust3r_from_torch_file(path: str) -> dict[str, torch.Tensor]:
    """An official DUSt3R / MASt3R linear-head checkpoint (weights under
    ``model``) -> ``Dust3rNet`` / ``Mast3rNet`` weights (the same names)."""
    return _plain(load_torch_file(path, "model"))


def netvlad_from_torch_file(path: str) -> dict[str, torch.Tensor]:
    """A pytorch-NetVlad checkpoint (``encoder.<i>``, ``pool.conv``,
    ``pool.centroids``) -> ``NetVLADNet`` weights (the same names)."""
    return _plain(load_torch_file(path))
