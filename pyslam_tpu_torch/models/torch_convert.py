"""Official torch checkpoints -> the port's state dicts (port of
``pyslam_tpu/models/torch_convert.py``, ``resnet.py:154-192``,
``cosplace.py:57-101`` and the ``*_from_torch`` converters of the learned
local-feature modules: ``patch_descriptors.py:200-290``, ``disk.py:79``,
``aliked.py:227``, ``r2d2.py:96``, ``d2net.py:61``, ``keynet.py:97``, and
of the dense matchers and VPR networks: ``loftr.py:281``,
``torch_convert.py:225-329``, and DepthAnythingV2's
``torch_convert.py:333-462``).

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
NetVLAD keep their official names; DepthAnythingV2's DINOv2 and DPT
names map to the JAX package's, its position embedding resized to the
network's grid.  Nothing is downloaded:
the caller names the file.
"""

from __future__ import annotations

import numpy as np
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


# ------------------------------------------------------- DepthAnythingV2
def _dav2_pos_embed(pe, grid_hw):
    """The official (1 + G * G, D) position embedding resized to the
    network's (h8, w8) patch grid, as the JAX package's converter does
    (``scipy.ndimage.zoom``, linear; its own bilinear sampling without
    scipy); the class token's row first."""
    g = int(round((pe.shape[0] - 1) ** 0.5))
    grid = pe[1:].reshape(g, g, pe.shape[1])
    h8, w8 = grid_hw
    try:
        from scipy.ndimage import zoom

        grid = zoom(grid, (h8 / g, w8 / g, 1), order=1)
    except ImportError:
        ys = np.clip((np.arange(h8) * g / h8), 0, g - 1)
        xs = np.clip((np.arange(w8) * g / w8), 0, g - 1)
        y0, x0 = ys.astype(int), xs.astype(int)
        y1, x1 = np.minimum(y0 + 1, g - 1), np.minimum(x0 + 1, g - 1)
        fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        grid = (grid[y0][:, x0] * (1 - fy) * (1 - fx) + grid[y0][:, x1] * (1 - fy) * fx
                + grid[y1][:, x0] * fy * (1 - fx) + grid[y1][:, x1] * fy * fx)
    return np.concatenate([pe[:1], grid.reshape(-1, pe.shape[1])], axis=0)


def depth_anything_v2_from_torch(state_dict, cfg) -> dict[str, torch.Tensor]:
    """An official DepthAnythingV2 checkpoint (``pretrained.*`` DINOv2 +
    ``depth_head.*`` DPT) -> ``DepthAnythingV2Net`` weights for ``cfg``
    (a ``DAv2Config``): the learned position embedding is resized from the
    checkpoint's grid to the network's; ``refinenet4``'s unused
    ``resConfUnit1`` is dropped."""
    sd = {k.replace("module.", ""): v.detach().cpu().float() for k, v in state_dict.items()}
    out = {"patch_embed.weight": sd["pretrained.patch_embed.proj.weight"],
           "patch_embed.bias": sd["pretrained.patch_embed.proj.bias"],
           "cls_token": sd["pretrained.cls_token"].reshape(1, -1),
           "encoder_norm.weight": sd["pretrained.norm.weight"],
           "encoder_norm.bias": sd["pretrained.norm.bias"]}
    pe = sd["pretrained.pos_embed"][0].numpy()
    h8, w8 = cfg.img_hw[0] // cfg.patch, cfg.img_hw[1] // cfg.patch
    if pe.shape[0] != 1 + h8 * w8:
        pe = _dav2_pos_embed(pe, (h8, w8))
    out["pos_embed"] = torch.from_numpy(np.ascontiguousarray(pe, np.float32))
    blk = {"norm1": "norm1", "attn.qkv": "qkv", "attn.proj": "attn_proj", "norm2": "norm2",
           "mlp.fc1": "fc1", "mlp.fc2": "fc2"}
    for i in range(cfg.depth):
        b = f"pretrained.blocks.{i}"
        for src, dst in blk.items():
            for leaf in ("weight", "bias"):
                out[f"block_{i}.{dst}.{leaf}"] = sd[f"{b}.{src}.{leaf}"]
        out[f"block_{i}.ls1"] = sd[f"{b}.ls1.gamma"]
        out[f"block_{i}.ls2"] = sd[f"{b}.ls2.gamma"]
    names = {f"depth_head.projects.{j}": f"project_{j}" for j in range(4)}
    names.update({f"depth_head.resize_layers.{j}": f"resize_{j}" for j in (0, 1, 3)})
    names.update({f"depth_head.scratch.layer{j}_rn": f"layer{j}_rn" for j in range(1, 5)})
    for r in range(1, 5):
        rn = f"depth_head.scratch.refinenet{r}"
        units = (("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2")) if r < 4 else \
            (("resConfUnit2", "rcu2"),)
        for src, dst in units:
            for conv in ("conv1", "conv2"):
                names[f"{rn}.{src}.{conv}"] = f"refine{r}.{dst}.{conv}"
        names[f"{rn}.out_conv"] = f"refine{r}.out_conv"
    names.update({"depth_head.scratch.output_conv1": "output_conv1",
                  "depth_head.scratch.output_conv2.0": "output_conv2a",
                  "depth_head.scratch.output_conv2.2": "output_conv2b"})
    for src, dst in names.items():
        for leaf in ("weight", "bias"):
            if f"{src}.{leaf}" in sd:
                out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]
    return out


def depth_anything_v2_from_torch_file(path: str, cfg) -> dict[str, torch.Tensor]:
    return depth_anything_v2_from_torch(load_torch_file(path), cfg)
