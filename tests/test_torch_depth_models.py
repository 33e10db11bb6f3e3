"""The depth models of the port (pyslam_tpu_torch/models/{vggt,depth_anything,
depth_anything_v2,depth_anything_v3,depth_pro,raft_stereo,crestereo,
mvdust3r}.py; the last three in tests/test_torch_depth_models_stereo.py,
with the constants of this file) against the JAX package's, with its
``PRNGKey(0)`` weights
carried across (``interop.*_state_dict``), the JAX package run with x64 off,
at the small sizes of its own tests (tests/test_depth_pro.py,
test_raft_stereo.py, test_depth_anything_v3.py, test_mvdust3r.py,
test_depth_anything_v2.py).

Tolerances: every map within ``TOL`` = 1e-4 of its largest magnitude
(``rel_err``); the recurrent stereo networks' disparities (RAFT 4
iterations, CREStereo 2 + 2) within ``STEREO_TOL`` = 1e-4 of theirs;
``_patch_positions``, ``recover_camera_from_rays`` on the same rays and
the interpolation taps of ``lookup`` and ``_group_corr_window`` within
1e-5 (the latter two sample the same float32 volumes at the same
positions, off both edges included).  DepthAnythingV2's official-layout
converter loads a synthesised torch-layout state dict into both packages:
the same maps within ``TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models import depth_anything as jdpt
from pyslam_tpu.models import depth_anything_v2 as jdav2
from pyslam_tpu.models import depth_anything_v3 as jda3
from pyslam_tpu.models import depth_pro as jpro
from pyslam_tpu.models import vggt as jvggt
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import (depth_anything, depth_anything_v2, depth_anything_v3,
                                     depth_pro, vggt)
from tests.torch_parity import compiled_flax_init, flat_variables, np_, rel_err, rng, t
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-4
STEREO_TOL = 1e-4
DAV2_TINY = dict(img_hw=(56, 70), patch=14, dim=32, depth=4, heads=2, taps=(0, 1, 2, 3),
                 out_ch=(8, 16, 24, 32), features=16)
DA3_SMALL = dict(img_hw=(64, 64), patch=16, dim=64, depth=4, heads=4, taps=(0, 1, 2, 3),
                 features=32)
PRO_SMALL = dict(img_px=128, patch_px=32, vit_patch=16, dim=48, depth=2, heads=4, features=32)
RAFT_TINY = dict(feat_dim=32, hidden_dim=32, context_dim=32, corr_levels=2, corr_radius=3,
                 iters=4, max_disp=64.0)
CRE_TINY = dict(feat_dim=32, hidden_dim=32, groups=2, iters_coarse=2, iters_fine=2,
                max_disp=16.0)
MV_SMALL = dict(img_hw=(64, 64), patch=16, enc_dim=48, enc_depth=2, enc_heads=4, dec_dim=48,
                dec_depth=2, dec_heads=4)


def _carry(params, net, convert=interop.same_names_state_dict):
    net.load_state_dict(convert(flat_variables(params)))
    return net


def test_vggt_block():
    blk = jvggt._Block(32, 4)
    x = rng(0).normal(size=(2, 10, 32)).astype(np.float32)
    with jax.enable_x64(False):
        params = blk.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = blk.apply(params, jnp.asarray(x))
    got = _carry(params, vggt._Block(32, 4))(t(x))
    assert rel_err(got.detach(), want) <= TOL


@pytest.fixture(scope="module")
def dpt():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jdpt.DepthAnythingInference()
    got = depth_anything.DepthAnythingInference(device="cpu")
    assert not got.trained
    _carry(ref.params, got.net, interop.dpt_lite_state_dict)
    return ref, got


def test_dpt_lite(dpt):
    ref, got = dpt
    img = rng(1).uniform(0, 255, (70, 100)).astype(np.float32)   # cropped to 64x96
    with jax.enable_x64(False):
        want = ref.infer(img)
    out = got.infer(img)
    assert out.shape == (70, 100) and (out[64:] == 0).all() and (out[:, 96:] == 0).all()
    assert rel_err(out, want) <= TOL


@pytest.fixture(scope="module")
def dav2():
    cfg = jdav2.DAv2Config(**DAV2_TINY)
    with jax.enable_x64(False), compiled_flax_init():
        ref = jdav2.DepthAnythingV2(cfg)
    got = depth_anything_v2.DepthAnythingV2(depth_anything_v2.DAv2Config(**DAV2_TINY),
                                            device="cpu")
    _carry(ref.params, got.net, interop.depth_anything_v2_state_dict)
    return ref, got


def test_dav2_infer(dav2):
    ref, got = dav2
    img = rng(2).integers(0, 255, (100, 130)).astype(np.uint8)
    with jax.enable_x64(False):
        want = ref.infer(img)
    out = got.infer(img)
    assert out.shape == (100, 130) and np.isfinite(out).all()
    assert rel_err(out, want) <= TOL


@pytest.mark.parametrize("j,k", [(0, 4), (1, 2)])
def test_dav2_transposed_convs(j, k):
    """flax ``ConvTranspose(transpose_kernel=True)``, "VALID", stride =
    kernel, is ``ConvTranspose2d`` with the (kh, kw, out, in) kernel as its
    (in, out, kh, kw) weight."""
    import flax.linen as nn

    x = rng(3 + j).normal(size=(1, 5, 6, 8)).astype(np.float32)
    ct = nn.ConvTranspose(8, (k, k), strides=(k, k), padding="VALID", transpose_kernel=True,
                          name=f"resize_{j}")
    with jax.enable_x64(False):
        params = ct.init(jax.random.PRNGKey(j), jnp.asarray(x))
        params = jax.tree.map(lambda p: p + 0.1, params)       # a nonzero bias too
        want = ct.apply(params, jnp.asarray(x))
    mod = torch.nn.ConvTranspose2d(8, 8, k, stride=k)
    mod.load_state_dict(interop.same_names_state_dict(flat_variables(params)))
    got = mod(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert rel_err(got.detach(), want) <= 1e-5


def _official_state_dict(cfg, n_pos: int, seed: int = 1) -> dict:
    """A random DepthAnythingV2 state dict under the official names, its
    position embedding over ``n_pos`` patches and the class token."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"pretrained.patch_embed.proj.weight": (cfg.dim, 3, cfg.patch, cfg.patch),
              "pretrained.patch_embed.proj.bias": (cfg.dim,),
              "pretrained.cls_token": (1, 1, cfg.dim),
              "pretrained.pos_embed": (1, 1 + n_pos, cfg.dim),
              "pretrained.norm.weight": (cfg.dim,), "pretrained.norm.bias": (cfg.dim,)}
    for i in range(cfg.depth):
        b = f"pretrained.blocks.{i}"
        for name, (o, n) in {"attn.qkv": (3 * cfg.dim, cfg.dim), "attn.proj": (cfg.dim, cfg.dim),
                             "mlp.fc1": (4 * cfg.dim, cfg.dim),
                             "mlp.fc2": (cfg.dim, 4 * cfg.dim)}.items():
            shapes[f"{b}.{name}.weight"], shapes[f"{b}.{name}.bias"] = (o, n), (o,)
        for name in ("norm1", "norm2"):
            shapes[f"{b}.{name}.weight"] = shapes[f"{b}.{name}.bias"] = (cfg.dim,)
        shapes[f"{b}.ls1.gamma"] = shapes[f"{b}.ls2.gamma"] = (cfg.dim,)
    f = cfg.features
    for j, oc in enumerate(cfg.out_ch):
        shapes[f"depth_head.projects.{j}.weight"] = (oc, cfg.dim, 1, 1)
        shapes[f"depth_head.projects.{j}.bias"] = (oc,)
        shapes[f"depth_head.scratch.layer{j + 1}_rn.weight"] = (f, oc, 3, 3)
    for j, k in ((0, 4), (1, 2)):
        oc = cfg.out_ch[j]
        shapes[f"depth_head.resize_layers.{j}.weight"] = (oc, oc, k, k)
        shapes[f"depth_head.resize_layers.{j}.bias"] = (oc,)
    shapes["depth_head.resize_layers.3.weight"] = (cfg.out_ch[3], cfg.out_ch[3], 3, 3)
    shapes["depth_head.resize_layers.3.bias"] = (cfg.out_ch[3],)
    for r in range(1, 5):
        rn = f"depth_head.scratch.refinenet{r}"
        for u in ("resConfUnit1", "resConfUnit2"):     # refinenet4's unit 1 goes unused
            for c in ("conv1", "conv2"):
                shapes[f"{rn}.{u}.{c}.weight"], shapes[f"{rn}.{u}.{c}.bias"] = (f, f, 3, 3), (f,)
        shapes[f"{rn}.out_conv.weight"], shapes[f"{rn}.out_conv.bias"] = (f, f, 1, 1), (f,)
    shapes["depth_head.scratch.output_conv1.weight"] = (f // 2, f, 3, 3)
    shapes["depth_head.scratch.output_conv1.bias"] = (f // 2,)
    shapes["depth_head.scratch.output_conv2.0.weight"] = (32, f // 2, 3, 3)
    shapes["depth_head.scratch.output_conv2.0.bias"] = (32,)
    shapes["depth_head.scratch.output_conv2.2.weight"] = (1, 32, 1, 1)
    shapes["depth_head.scratch.output_conv2.2.bias"] = (1,)
    return {k: torch.randn(s, generator=g) * 0.08 for k, s in shapes.items()}


@pytest.mark.parametrize("grid", [None, 7])
def test_dav2_official_converter(dav2, grid):
    """The official layout into both packages: on the network's own patch
    grid, and on a 7 x 7 grid whose position embedding each package
    resizes to the network's 4 x 5."""
    from pyslam_tpu.models.torch_convert import depth_anything_v2_from_torch as jconvert
    from pyslam_tpu_torch.models.torch_convert import depth_anything_v2_from_torch

    ref, _ = dav2
    cfg = depth_anything_v2.DAv2Config(**DAV2_TINY)
    sd = _official_state_dict(cfg, grid * grid if grid else 4 * 5)
    jparams = jconvert(sd, ref.params)
    got = depth_anything_v2.DepthAnythingV2(cfg, device="cpu")
    got.net.load_state_dict(depth_anything_v2_from_torch(sd, cfg))
    img = rng(4).uniform(-1, 1, (56, 70, 3)).astype(np.float32)
    with jax.enable_x64(False):
        want = ref.net.apply(jparams, jnp.asarray(img))
    with torch.no_grad():
        out = got.net(t(img))
    assert rel_err(out, want) <= TOL


@pytest.fixture(scope="module")
def da3():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jda3.DepthAnything3(jda3.DA3Config(**DA3_SMALL))
    got = depth_anything_v3.DepthAnything3(depth_anything_v3.DA3Config(**DA3_SMALL),
                                           device="cpu")
    _carry(ref.params, got.net, interop.da3_state_dict)
    return ref, got


def test_da3_inference(da3):
    ref, got = da3
    r = rng(5)
    imgs = [r.uniform(0, 255, (80, 100, 3)).astype(np.float32) for _ in range(3)]
    with jax.enable_x64(False):
        want = ref.inference(imgs)
    out = got.inference(imgs)
    for k in ("depth", "conf", "origin", "direction", "points"):
        assert out[k].shape == want[k].shape, k
        assert rel_err(out[k], want[k]) <= TOL, k
    assert np.abs(out["poses"] - want["poses"]).max() <= 1e-3
    assert np.abs(out["focals"] - want["focals"]).max() / want["focals"].max() <= 1e-3


def test_recover_camera_from_rays():
    r = rng(6)
    H, W = 12, 16
    origin = r.normal(size=(H, W, 3))
    direction = r.normal(size=(H, W, 3))
    Tj, fj = jda3.recover_camera_from_rays(origin, direction, (H, W))
    Tp, fp = depth_anything_v3.recover_camera_from_rays(origin, direction, (H, W))
    assert np.abs(Tj - Tp).max() <= 1e-5 and abs(fj - fp) <= 1e-5 * fj


@pytest.mark.parametrize("S,P", [(1536, 384), (768, 384), (384, 384), (128, 32), (64, 32),
                                 (100, 32)])
def test_depth_pro_patch_positions(S, P):
    assert depth_pro._patch_positions(S, P, 0.25) == jpro._patch_positions(S, P, 0.25)


def test_depth_pro_stitch():
    """Overlapping patch grids averaged where they overlap, counted once
    where one patch covers a cell."""
    cfg = depth_pro.DepthProConfig(**PRO_SMALL)
    net = depth_pro.DepthProNet(cfg)
    size, pos = net.layout()[0]                       # 128 px, patches of 32 at 0, 24, ...
    g, gs = cfg.patch_px // cfg.vit_patch, size // cfg.vit_patch
    feats = rng(7).normal(size=(len(pos) ** 2, g, g, cfg.dim)).astype(np.float32)
    acc = np.zeros((gs, gs, cfg.dim), np.float64)
    cnt = np.zeros((gs, gs, 1))
    i = 0
    for y0 in pos:
        for x0 in pos:
            acc[y0 // 16:y0 // 16 + g, x0 // 16:x0 // 16 + g] += feats[i]
            cnt[y0 // 16:y0 // 16 + g, x0 // 16:x0 // 16 + g] += 1
            i += 1
    got = net.stitch(t(feats), size, pos)
    assert np.abs(np_(got) - acc / np.maximum(cnt, 1)).max() <= 1e-5


@pytest.fixture(scope="module")
def pro():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jpro.DepthPro(jpro.DepthProConfig(**PRO_SMALL))
    got = depth_pro.DepthPro(depth_pro.DepthProConfig(**PRO_SMALL), device="cpu")
    _carry(ref.params, got.net, interop.depth_pro_state_dict)
    return ref, got


@pytest.mark.parametrize("f_px", [None, 100.0])
def test_depth_pro_infer(pro, f_px):
    ref, got = pro
    img = rng(8).uniform(0, 255, (96, 140, 3)).astype(np.float32)
    with jax.enable_x64(False):
        want, f_want = ref.infer(img, f_px=f_px)
        cinv, fov = ref._run(ref.params, jnp.asarray(got.prepare(img).transpose(1, 2, 0)))
    c_got, fov_got = got.run(got.prepare(img))
    assert rel_err(c_got, cinv) <= TOL and abs(float(fov_got) - float(fov)) <= 1e-4
    out, f_got = got.infer(img, f_px=f_px)
    assert out.shape == (96, 140) and abs(f_got - f_want) <= 1e-4 * f_want
    assert rel_err(out, want) <= TOL
