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
``lightglue_state_dict``, ``resnet_state_dict``, ``cosplace_state_dict``
and the local features' ``hardnet_state_dict`` (HardNet, L2Net, SOSNet,
the log-polar net), ``tfeat_state_dict``, ``xfeat_state_dict``,
``aliked_state_dict``, ``r2d2_state_dict`` and ``same_names_state_dict``
(GeoDesc, DISK, D2-Net, Key.Net, LF-Net, DELF, ContextDesc), and the
dense matchers' and VPR networks' ``loftr_state_dict``,
``dust3r_state_dict`` / ``mast3r_state_dict``, ``netvlad_state_dict``,
``megaloc_state_dict`` and ``alexnet_state_dict``, and the depth
models' ``dpt_lite_state_dict``, ``depth_anything_v2_state_dict``,
``da3_state_dict``, ``depth_pro_state_dict``, ``raft_stereo_state_dict``,
``crestereo_state_dict`` and ``mvdust3r_state_dict``, the 3D
reconstruction models' ``vggt_state_dict`` and ``fast3r_state_dict``, and the semantic
models' ``deeplabv3_state_dict``, ``segformer_state_dict``,
``clip_state_dict``, ``yolo_seg_state_dict`` and ``detr_state_dict`` take the JAX
package's flat parameters (the ``params/...`` keys of its ``.npz``
checkpoints, numpy arrays, as ``pyslam_tpu/models/torch_convert.py``
flattens them) and return the port's ``state_dict``: a flax convolution
kernel (kh, kw, I, O) becomes (O, I, kh, kw), a Dense kernel (in, out) an
``nn.Linear`` weight (out, in) (a Dense over k*k taps a conv weight), a
LayerNorm ``scale`` its ``weight``, a flax module path the official
module's name where the port keeps an official layout, an ``Embed``'s
``embedding`` an ``nn.Embedding`` weight; batch-norm statistics,
``rotary_w``, ``gem_p`` and the other raw parameters (position
embeddings, class tokens, CLIP's projections) keep their values.
``superpoint_flat``, ``lightglue_flat`` and ``cosplace_flat`` are the
inverses of the first, second and fourth: a port ``state_dict`` (the
trainers' output) as the JAX package's flat ``params/...`` names, so a
checkpoint the port trains loads through both packages' ``checkpoint=``.
``segformer_npz_state_dict`` reads the JAX package's SegFormer ``.npz``,
whose values follow the sorted order of its keys, leaf by leaf of the
flax tree.  ``bundled_checkpoint``
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
    v = np.array(v, np.float32)
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


def _flat(state: dict, flax_path, vector_weight: str = "weight") -> dict[str, np.ndarray]:
    """The inverse of ``_convert``: ``params/...`` leaves (float32 numpy)
    from a port ``state_dict``.  ``flax_path`` maps a torch module's dotted
    name to its flax path (tuple of names); a 4-d ``weight`` becomes a conv
    ``kernel`` (kh, kw, I, O), a 2-d one a Dense ``kernel`` (in, out), a
    1-d one ``vector_weight`` (``scale`` for a LayerNorm, ``weight`` for
    the batch norms); other leaves keep their names and values."""
    out = {}
    for key, v in state.items():
        mod, _, leaf = key.rpartition(".")
        a = v.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            if a.ndim == 4:
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                leaf, a = "kernel", a.T
            else:
                leaf = vector_weight
        out["/".join(("params",) + flax_path(mod) + (leaf,))] = np.ascontiguousarray(a)
    return out


def superpoint_flat(state: dict) -> dict[str, np.ndarray]:
    """Flax ``Conv_0..Conv_11`` leaves of a ``SuperPointNet`` state_dict."""
    return _flat(state, lambda m: (f"Conv_{SUPERPOINT_CONVS.index(m)}",))


def lightglue_flat(state: dict) -> dict[str, np.ndarray]:
    """Flax leaves of a ``LightGlueNet`` state_dict (the same module names;
    the LayerNorms' ``scale``)."""
    return _flat(state, lambda m: tuple(m.split(".")) if m else (), vector_weight="scale")


def _resnet_path(mod: str) -> tuple:
    """Inverse of ``_resnet_module``: ``layer2.0`` -> ``layer2_0``,
    ``downsample.0`` / ``.1`` -> ``downsample_conv`` / ``downsample_bn``."""
    parts, out = mod.split(".") if mod else [], []
    i = 0
    while i < len(parts):
        part = parts[i]
        if part.startswith("layer") and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{part}_{parts[i + 1]}")
            i += 2
        elif part == "downsample":
            out.append({"0": "downsample_conv", "1": "downsample_bn"}[parts[i + 1]])
            i += 2
        else:
            out.append(part)
            i += 1
    return tuple(out)


def cosplace_flat(state: dict) -> dict[str, np.ndarray]:
    """Flax leaves of a ``GeoLocalizationNet`` state_dict (``backbone``,
    ``gem_p``, ``fc``; the batch norms' four tensors by their own names)."""
    return _flat(state, _resnet_path)


def _renamed(flat: dict, names: dict) -> dict[str, torch.Tensor]:
    """state_dict from the ``params/`` leaves of ``flat`` whose flax module
    path (slash-joined) ``names`` maps to a torch module name; the other
    module paths keep their names with dots."""
    return _convert(flat, lambda p: names.get("/".join(p), ".".join(p)))


def _indexed(src: str, dst: str, idx) -> dict[str, str]:
    """flax ``{src}conv{j}`` / ``{src}bn{j}`` -> the official Sequential's
    ``{dst}.{idx[j]}`` and ``{dst}.{idx[j] + 1}``."""
    out = {}
    for j, i in enumerate(idx):
        out[f"{src}conv{j}"] = f"{dst}.{i}"
        out[f"{src}bn{j}"] = f"{dst}.{i + 1}"
    return out


# the convolutions' indices in the official Sequentials
HARDNET_CONV_IDX = (0, 3, 6, 9, 12, 15, 19)
R2D2_CONV_IDX = (0, 3, 6, 9, 12, 15, 18, 20, 22)
XFEAT_BASIC_LAYERS = (
    "block1.0", "block1.1", "block1.2", "block1.3", "block2.0", "block2.1",
    "block3.0", "block3.1", "block3.2", "block4.0", "block4.1", "block4.2",
    "block5.0", "block5.1", "block5.2", "block5.3", "block_fusion.0", "block_fusion.1",
    "heatmap_head.0", "heatmap_head.1", "keypoint_head.0", "keypoint_head.1",
    "keypoint_head.2")
XFEAT_PLAIN_CONVS = {"skip1_conv": "skip1.1", "fusion_conv": "block_fusion.2",
                     "heatmap_conv": "heatmap_head.2", "keypoint_conv": "keypoint_head.3"}


def hardnet_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """HardNet / L2Net / SOSNet / LogPolarDesc weights: flax
    ``features/conv{j}``, ``features/bn{j}`` -> the ``features``
    Sequential's indices."""
    return _renamed(flat, _indexed("features/", "features", HARDNET_CONV_IDX))


def tfeat_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """TFeat: ``conv0``, ``conv1``, ``fc`` -> ``features.1``,
    ``features.4``, ``classifier.0``."""
    return _renamed(flat, {"conv0": "features.1", "conv1": "features.4",
                           "fc": "classifier.0"})


def same_names_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """The weights of a model whose modules carry the flax names (GeoDesc,
    DISK, D2-Net, Key.Net, LF-Net, DELF, ContextDesc's towers)."""
    return _convert(flat, ".".join)


def xfeat_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``XFeatNet`` weights (the public XFeatModel's names) from flax
    ``BasicLayer_{i}`` (conv ``Conv_0``, running statistics in
    ``batch_stats/.../BatchNorm_0``) and the four plain convolutions."""
    names = {f"BasicLayer_{i}/Conv_0": f"{pre}.layer.0"
             for i, pre in enumerate(XFEAT_BASIC_LAYERS)}
    names.update(XFEAT_PLAIN_CONVS)
    out = _renamed(flat, names)
    for i, pre in enumerate(XFEAT_BASIC_LAYERS):
        for leaf, name in (("mean", "running_mean"), ("var", "running_var")):
            out[f"{pre}.layer.1.{name}"] = _leaf(
                leaf, flat[f"batch_stats/BasicLayer_{i}/BatchNorm_0/{leaf}"])
    return out


def _dense_to_conv(kernel: np.ndarray, k: int) -> torch.Tensor:
    """A Dense kernel over k*k taps (tap-major, channel-minor; (k*k*C, O))
    -> a conv weight (O, C, k, k)."""
    kernel = np.asarray(kernel, np.float32)
    c = kernel.shape[0] // (k * k)
    return torch.from_numpy(np.ascontiguousarray(
        kernel.reshape(k, k, c, kernel.shape[1]).transpose(3, 2, 0, 1)))


def aliked_state_dict(net_flat: dict, head_flat: dict, K: int = 3) -> dict[str, torch.Tensor]:
    """``AlikedNet`` weights (the official ALIKED names) from the JAX
    package's ``AlikedNet`` and ``SDDH`` trees: the deformable convs' and
    the offset head's Dense kernels become conv weights."""
    names = {"score0": "score_head.0", "score1": "score_head.2", "score2": "score_head.4",
             "score3": "score_head.6"}
    out = _renamed(net_flat, names)
    for blk in ("block3", "block4"):
        for c in ("conv1", "conv2"):
            out[f"{blk}.{c}.conv.weight"] = _dense_to_conv(
                net_flat[f"params/{blk}/{c}/conv/kernel"], 3)
    out.update({f"desc_head.{k}": v for k, v in _renamed(head_flat, {
        "offset_conv0": "offset_conv.0", "offset_conv1": "offset_conv.2"}).items()})
    out["desc_head.offset_conv.0.weight"] = _dense_to_conv(
        head_flat["params/offset_conv0/kernel"], K)
    for name in ("offset_conv.2", "sf_conv"):               # 1x1 convs
        w = out[f"desc_head.{name}.weight"]
        out[f"desc_head.{name}.weight"] = w[:, :, None, None].contiguous()
    return out


def r2d2_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``R2D2Net`` weights: flax ``conv{j}`` / ``bn{j}`` -> the official
    ``ops`` list's indices; ``clf`` and ``sal`` keep their names."""
    return _renamed(flat, _indexed("", "ops", R2D2_CONV_IDX))


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


# ------------------------------------------ dense matchers and VPR networks
_LOFTR_FPN = {"l3_out": "layer3_outconv", "l2_out": "layer2_outconv",
              "l2_fuse1": "layer2_outconv2.0", "l2_fuse_bn": "layer2_outconv2.1",
              "l2_fuse2": "layer2_outconv2.3", "l1_out": "layer1_outconv",
              "l1_fuse1": "layer1_outconv2.0", "l1_fuse_bn": "layer1_outconv2.1",
              "l1_fuse2": "layer1_outconv2.3"}
_LOFTR_TRANSFORMERS = {"coarse": "loftr_coarse", "fine": "loftr_fine"}


def _loftr_module(path: tuple) -> str:
    head, rest = path[0], path[1:]
    if head == "backbone":
        return ".".join(["backbone"] + [_LOFTR_FPN.get(p) or _resnet_module((p,))
                                         for p in rest])
    if head in _LOFTR_TRANSFORMERS:
        kind, i = rest[0].split("_")                   # self_i / cross_i
        layer = 2 * int(i) + (kind == "cross")
        sub = {"mlp1": "mlp.0", "mlp2": "mlp.2"}.get(rest[1], rest[1])
        return f"{_LOFTR_TRANSFORMERS[head]}.layers.{layer}.{sub}"
    return f"fine_preprocess.{head}"                   # down_proj, merge_feat


def loftr_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``LoFTRNet`` weights (the official names) from the JAX package's
    ``LoFTRNet`` tree: ``backbone/layer{i}_{j}`` and the FPN's
    ``l{2,3}_out`` / ``l{1,2}_fuse*``, ``coarse|fine/self_i|cross_i`` ->
    ``loftr_{coarse,fine}.layers.{2i|2i+1}`` (``mlp1`` / ``mlp2`` ->
    ``mlp.0`` / ``mlp.2``), ``down_proj`` / ``merge_feat`` ->
    ``fine_preprocess.*``."""
    return _convert(flat, _loftr_module)


def _dust3r_module(path: tuple) -> str:
    head, rest = path[0], path[1:]
    if head == "patch_embed":
        return "patch_embed.proj"
    for pre, name in (("enc_", "enc_blocks"), ("dec1_", "dec_blocks"), ("dec2_", "dec_blocks2")):
        if head.startswith(pre) and head[len(pre):].isdigit():
            return ".".join((f"{name}.{head[len(pre):]}",) + rest)
    if head in ("head1", "head2"):
        return f"downstream_head{head[-1]}.proj"
    if head.startswith("local"):                       # local{v}_fc{j}
        v, fc = head[len("local"):].split("_")
        return f"downstream_head{v}.head_local_features.{fc}"
    return ".".join(path)                              # enc_norm, decoder_embed, dec_norm


def dust3r_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``Dust3rNet`` / ``Mast3rNet`` weights (the official DUSt3R names)
    from the JAX package's tree: ``patch_embed`` -> ``patch_embed.proj``,
    ``enc_i`` / ``dec1_i`` / ``dec2_i`` -> ``enc_blocks.i`` /
    ``dec_blocks.i`` / ``dec_blocks2.i``, ``head{v}`` ->
    ``downstream_head{v}.proj`` and MASt3R's ``local{v}_fc{j}`` ->
    ``downstream_head{v}.head_local_features.fc{j}``."""
    return _convert(flat, _dust3r_module)


mast3r_state_dict = dust3r_state_dict

VGG16_FEATURE_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def netvlad_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``NetVLADNet`` weights (pytorch-NetVlad names): ``encoder/conv_i``
    -> ``encoder.{torchvision index}``, the soft assignment's Dense (D, K)
    -> the 1x1 ``pool.conv`` (K, D, 1, 1), ``pool.centroids`` as is."""
    out = _renamed(flat, {f"encoder/conv_{i}": f"encoder.{j}"
                          for i, j in enumerate(VGG16_FEATURE_IDX)})
    w = out.pop("pool.assign.weight")
    out["pool.conv.weight"] = w[:, :, None, None].contiguous()
    return out


def megaloc_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``MegaLocNet`` weights: its modules carry the flax names
    (``block_i`` ViT blocks with ``ls1`` / ``ls2``, ``cls_token``,
    ``pos_embed``)."""
    return _convert(flat, ".".join)


def alexnet_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``AlexNetConv3`` weights (torchvision names): ``conv{j}`` ->
    ``features.{0, 3, 6}[j]``."""
    return _renamed(flat, {f"conv{j}": f"features.{i}" for j, i in enumerate((0, 3, 6))})


# the depth models carry the flax names (a GroupNorm's ``scale`` becomes
# its ``weight``): DPT-lite, DepthAnythingV2 / V3, DepthPro, RAFT-Stereo,
# CREStereo and MV-DUSt3R
dpt_lite_state_dict = same_names_state_dict
depth_anything_v2_state_dict = same_names_state_dict
da3_state_dict = same_names_state_dict
depth_pro_state_dict = same_names_state_dict
raft_stereo_state_dict = same_names_state_dict
crestereo_state_dict = same_names_state_dict
mvdust3r_state_dict = same_names_state_dict
# the 3D reconstruction models: ``patch_embed``, ``frame_i`` / ``global_i``
# (VGGT) and ``enc_i`` / ``dec_i`` (Fast3R) keep their flax names
vggt_state_dict = same_names_state_dict
fast3r_state_dict = same_names_state_dict


# ---------------------------------------------------------- semantic models
def deeplabv3_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """``DeepLabV3`` weights: ``backbone/...`` as ``resnet_state_dict``
    maps it (torchvision names), the head's modules keep the flax names."""
    return _convert(flat, lambda p: ("backbone." + _resnet_module(p[1:])
                                     if p[0] == "backbone" else ".".join(p)))


segformer_state_dict = same_names_state_dict


def _flax_leaf_paths(net: torch.nn.Module) -> list[tuple[tuple, str]]:
    """(flax path, state_dict key) of every weight of a module that
    carries the flax names, in the flax tree's leaf order (keys sorted at
    every level): a Conv / Dense weight is a ``kernel``, a LayerNorm's a
    ``scale``."""
    out = []
    for mname, mod in net.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            leaf = pname
            if pname == "weight":
                leaf = "scale" if isinstance(mod, torch.nn.LayerNorm) else "kernel"
            path = ("params",) + (tuple(mname.split(".")) if mname else ()) + (leaf,)
            out.append((path, f"{mname}.{pname}" if mname else pname))
    return sorted(out)


def segformer_npz_state_dict(path: str, net: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The JAX package's SegFormer checkpoint (``SegFormerInference.
    load_checkpoint``: the i-th of the file's sorted keys is the flax
    tree's i-th leaf) -> ``SegFormerNet`` weights."""
    z = read_npz(path)
    leaves = _flax_leaf_paths(net)
    if len(z) != len(leaves):
        raise ValueError(f"{path}: {len(z)} arrays for {len(leaves)} weights")
    return {key: _leaf(fpath[-1], z[name])
            for (fpath, key), name in zip(leaves, sorted(z))}


def _embed_renamed(sd: dict) -> dict[str, torch.Tensor]:
    return {(k[: -len("embedding")] + "weight" if k.endswith(".embedding") else k): v
            for k, v in sd.items()}


def clip_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """A CLIP tower's weights (``CLIPImageTower`` or ``CLIPTextTower``):
    the modules keep the flax names, ``token_embed``'s ``embedding``
    becomes its weight, ``cls`` / ``pos_embed`` / ``proj`` keep their
    values."""
    return _embed_renamed(same_names_state_dict(flat))


# YOLO-seg and DETR carry the flax names (BN statistics are parameters of
# the JAX package's ``BN``, buffers of the port's)
yolo_seg_state_dict = same_names_state_dict
detr_state_dict = same_names_state_dict
