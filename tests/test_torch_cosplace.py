"""ResNet and CosPlace / EigenPlaces in the port
(pyslam_tpu_torch/models/{resnet,cosplace}.py) against the JAX package's,
the COSPLACE loop detector's descriptors, database candidates and saved
state against the JAX package's, and the retrieval floor of
tests/test_trained_matcher_vpr.py on the port.  Inputs: numpy seeds and the
JAX package's procedural places (``models.train_cosplace``).

Tolerances: ResNet feature maps within 1e-4 relative to their largest
magnitude; global descriptors (unit vectors) within 1e-4 absolute;
database candidates identical.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.config_parameters import Parameters as JaxParameters
from pyslam_tpu.loop_closing.keyframe_database import KeyFrameDatabase as JaxKeyFrameDatabase
from pyslam_tpu.loop_closing.loop_closing import LoopDetector as JaxLoopDetector
from pyslam_tpu.loop_closing.loop_detector_configs import LoopDetectorConfigs as JaxConfigs
from pyslam_tpu.models.cosplace import CosPlaceExtractor as JaxCosPlace
from pyslam_tpu.models.cosplace import cosplace_from_torch as jax_cosplace_from_torch
from pyslam_tpu.models.resnet import ResNet as JaxResNet
from pyslam_tpu.models.resnet import resnet_from_torch as jax_resnet_from_torch
from pyslam_tpu.models.train_cosplace import place_texture, render_view
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.loop_closing.keyframe_database import KeyFrameDatabase
from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
from pyslam_tpu_torch.loop_closing.loop_detector_configs import LoopDetectorConfigs
from pyslam_tpu_torch.models.cosplace import CosPlaceExtractor, GeoLocalizationNet
from pyslam_tpu_torch.models.resnet import ResNet
from pyslam_tpu_torch.models.torch_convert import resnet_from_torch
from tests.torch_parity import np_
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-4
HW = (96, 128)   # the bundled net's training view


@pytest.fixture
def vpr_flag():
    """``LoopDetector`` sets kRetainImageForVPR in each package: restore it."""
    saved = JaxParameters.kRetainImageForVPR, Parameters.kRetainImageForVPR
    yield
    JaxParameters.kRetainImageForVPR, Parameters.kRetainImageForVPR = saved


@pytest.fixture(scope="module")
def extractors():
    with jax.enable_x64(False):
        ref = JaxCosPlace(image_hw=HW)
    return ref, CosPlaceExtractor(image_hw=HW, device="cpu")


def _close_maps(a, b):
    return np.abs(a - b).max() <= TOL * max(1.0, np.abs(b).max())


def test_resnet9_bundled_trunk(extractors):
    """The bundled resnet9 (width 16) trunk and its stage taps, 2x64x96."""
    ref, _ = extractors
    flat = interop.read_npz(interop.bundled_checkpoint("cosplace_tiny"))
    trunk = {k.replace("params/backbone/", "params/"): v for k, v in flat.items()
             if k.startswith("params/backbone/")}
    net = ResNet("resnet9", width=16)
    net.load_state_dict(interop.resnet_state_dict(trunk))
    x = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(np.float32)
    with jax.enable_x64(False):
        out, taps = JaxResNet(arch="resnet9", width=16).apply(
            {"params": ref.variables["params"]["backbone"]}, jnp.asarray(x), return_taps=True)
    with torch.no_grad():
        got, got_taps = net(torch.from_numpy(x).permute(0, 3, 1, 2), return_taps=True)
    assert got.shape == (2, 128, 2, 3)
    assert _close_maps(np_(got).transpose(0, 2, 3, 1), np.asarray(out))
    for name, v in taps.items():
        assert _close_maps(np_(got_taps[name]).transpose(0, 2, 3, 1), np.asarray(v)), name


def _torchvision_state(arch, seed):
    """A torchvision-layout resnet state dict (fc head and
    num_batches_tracked included), random weights and statistics."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in ResNet(arch).state_dict().items():
        if k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
        elif k.endswith(("running_mean", "bias")):
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
        elif v.ndim == 1:
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.mark.parametrize("dilate", [(False, False, False), (False, True, True)])
def test_resnet18_from_torchvision_layout(dilate):
    """resnet18 (width 64) from a torchvision state dict converted by both
    packages; with ``dilate`` torchvision's replace_stride_with_dilation
    of DeepLabv3."""
    sd = _torchvision_state("resnet18", 1)
    net = ResNet("resnet18", dilate=dilate)
    net.load_state_dict(resnet_from_torch(sd))
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(np.float32)
    with jax.enable_x64(False):
        out = JaxResNet(arch="resnet18", dilate=dilate).apply(
            {"params": jax_resnet_from_torch({k: v.numpy() for k, v in sd.items()})},
            jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (1, 512, 8, 8) if dilate[1] else (1, 512, 2, 2)
    assert _close_maps(np_(got).transpose(0, 2, 3, 1), np.asarray(out))


def _images():
    r = np.random.default_rng(2)
    tex = place_texture(900003)
    return {"grey 8-bit": r.uniform(0, 255, (90, 120)).astype(np.float32),
            "rgb view": render_view(tex, r),
            "rgb in [0, 1]": render_view(tex, r) / 255.0,
            "larger than the canvas": r.uniform(0, 255, (120, 150)).astype(np.float32)}


@pytest.mark.parametrize("name", list(_images()))
def test_cosplace_descriptor(extractors, name):
    ref, got = extractors
    img = _images()[name]
    assert ref.trained and got.trained and got.out_dim == 128
    with jax.enable_x64(False):
        want = np.asarray(ref(img))
    d = got(img)
    assert d.shape == (128,) and d.dtype == np.float32
    assert np.abs(d - want).max() <= TOL
    assert abs(np.linalg.norm(d) - 1.0) < 1e-5


def test_official_cosplace_checkpoint_loads_in_both(tmp_path):
    """A CosPlace hub checkpoint (Sequential backbone ``backbone.N.``, GeM
    ``aggregation.1.p``, linear ``aggregation.3``), random weights written
    here: both packages infer resnet18 / 64 and agree."""
    seq = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
           "layer4": "7"}
    sd = {}
    for k, v in _torchvision_state("resnet18", 3).items():
        head, rest = k.split(".", 1)
        if head != "fc":
            sd[f"backbone.{seq[head]}.{rest}"] = v
    g = torch.Generator().manual_seed(4)
    sd["aggregation.1.p"] = torch.tensor([2.5])
    sd["aggregation.3.weight"] = torch.randn(64, 512, generator=g) / 512 ** 0.5
    sd["aggregation.3.bias"] = torch.zeros(64)
    path = str(tmp_path / "cosplace_resnet18_64.pth")
    torch.save(sd, path)
    img = np.random.default_rng(5).uniform(0, 255, (60, 80)).astype(np.float32)
    with jax.enable_x64(False):
        ref = JaxCosPlace(checkpoint=path, image_hw=(64, 96))
        want = np.asarray(ref(img))
        assert jax_cosplace_from_torch({k: v.numpy() for k, v in sd.items()})[1:] == (
            "resnet18", 64)
    got = CosPlaceExtractor(checkpoint=path, image_hw=(64, 96), device="cpu")
    assert got.trained and got.net.backbone.arch == "resnet18" and got.out_dim == 64
    assert float(got.net.gem_p.detach()) == 2.5
    assert np.abs(got(img) - want).max() <= TOL


def test_trained_cosplace_retrieves_heldout_places(extractors):
    """Recall@1 on 16 held-out places (the JAX package's
    ``train_cosplace.evaluate``): >= 0.75, and > a random net's + 0.2."""
    _, got = extractors

    def recall(net):
        r = np.random.default_rng(7777)
        mean = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
        std = np.array([0.229, 0.224, 0.225], np.float32) * 255.0

        def run(v):
            x = torch.from_numpy(((v - mean) / std).astype(np.float32)).permute(2, 0, 1)
            with torch.no_grad():
                return np_(net(x[None]))[0]

        texs = [place_texture(900000 + p) for p in range(16)]
        gallery = np.stack([run(render_view(tx, r)) for tx in texs])
        return np.mean([int(np.argmax(gallery @ run(render_view(texs[q], r)))) == q
                        for q in range(16)])

    rand = interop.seeded_init_(GeoLocalizationNet("resnet9", 128, width=16), 3).eval()
    r1, r1_rand = recall(got.net), recall(rand)
    assert r1 >= 0.75, r1
    assert r1 > r1_rand + 0.2, (r1, r1_rand)


# ------------------------------------------------------- the loop detector
def _frame(img, des_seed=0, vpr=True):
    a = np.asarray(img, np.float32)
    if a.ndim == 3:
        a = a.mean(axis=2)
    h, w = a.shape
    ph, pw = max(h // 64, 1), max(w // 64, 1)
    thumb = a[: (h // ph) * ph, : (w // pw) * pw].reshape(h // ph, ph, w // pw, pw).mean(
        axis=(1, 3))
    r = np.random.default_rng(des_seed)
    return SimpleNamespace(img_vpr=a[::2, ::2].astype(np.uint8) if vpr else None,
                           img_thumb=thumb, des=r.normal(size=(40, 32)).astype(np.float32),
                           valid=r.uniform(size=40) > 0.3)


@pytest.mark.parametrize("preset", ["COSPLACE", "EIGENPLACES"])
def test_describe_frame(vpr_flag, preset):
    """``describe_frame``: (None, descriptor) of ``img_vpr``, of
    ``img_thumb`` without it, and the normalised descriptor mean without
    either, against the JAX package's."""
    Parameters.kRetainImageForVPR = JaxParameters.kRetainImageForVPR = False
    with jax.enable_x64(False):
        ref = JaxLoopDetector(JaxConfigs.get(preset))
    got = LoopDetector(LoopDetectorConfigs.get(preset), device="cpu")
    assert got.score_based and ref.score_based and got.netvlad.trained
    assert Parameters.kRetainImageForVPR
    view = render_view(place_texture(900001), np.random.default_rng(0))
    frames = [_frame(view), _frame(view, vpr=False), _frame(view, vpr=False)]
    frames[2].img_thumb = None
    for f in frames:
        with jax.enable_x64(False):
            w_ref, g_ref = ref.describe_frame(f)
        words, g = got.describe_frame(f)
        assert words is None and w_ref is None
        assert np.abs(g - np.asarray(g_ref)).max() <= TOL


def _database(cls, describe, views, kids):
    db = cls(4096)
    for kid, v in zip(kids, views):
        db.add(kid, None, describe(_frame(v))[1])
    return db


def test_loop_and_relocalization_candidates(vpr_flag):
    """Seven keyframes from three places (two or three views each) in
    each package's database, described by each package's COSPLACE
    detector: the loop candidates of a new view of every place and the
    relocalisation candidates (the five best) are identical."""
    with jax.enable_x64(False):
        ref = JaxLoopDetector(JaxConfigs.get("COSPLACE"))
    got = LoopDetector(LoopDetectorConfigs.get("COSPLACE"), device="cpu")
    r = np.random.default_rng(11)
    places = [0, 1, 2, 0, 1, 2, 0]
    texs = {p: place_texture(900010 + p) for p in set(places)}
    views = [render_view(texs[p], r) for p in places]
    kids = list(range(len(views)))
    with jax.enable_x64(False):
        db_ref = _database(JaxKeyFrameDatabase, ref.describe_frame, views, kids)
    db = _database(KeyFrameDatabase, got.describe_frame, views, kids)
    covis = {k: [j for j in kids if j != k and abs(j - k) == 1] for k in kids}
    for p, tex in texs.items():
        q = _frame(render_view(tex, r))
        with jax.enable_x64(False):
            g_ref = ref.describe_frame(q)[1]
        g = got.describe_frame(q)[1]
        want = db_ref.detect_loop_candidates(99, None, g_ref, {6}, covis.get)
        assert db.detect_loop_candidates(99, None, g, {6}, covis.get) == want
        assert want, f"place {p}: no candidate"
        want = db_ref.detect_relocalization_candidates(None, g_ref)
        assert db.detect_relocalization_candidates(None, g) == want and len(want) == 5


def test_saved_state_reloads_the_database(vpr_flag, tmp_path):
    """A COSPLACE loop-closing state (global descriptors, no words) saved by
    the port reloads its ``kf_gdes`` into the port and into the JAX
    package, and the JAX package's save into the port."""
    from pyslam_tpu.features.tracker import feature_tracker_factory as jax_tracker_factory
    from pyslam_tpu.loop_closing.loop_closing import LoopClosing as JaxLoopClosing
    from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
    from pyslam_tpu.slam.map import Map as JaxMap
    from pyslam_tpu_torch.features.tracker import feature_tracker_factory
    from pyslam_tpu_torch.loop_closing.loop_closing import LoopClosing
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.map import Map

    cam_args = (160, 120, 100.0, 100.0, 80.0, 60.0)
    tracker = feature_tracker_factory("ORB2", device="cpu")

    def port_lc():
        return LoopClosing(Map(device="cpu"), PinholeCamera(*cam_args), tracker, "COSPLACE",
                           device="cpu")

    with jax.enable_x64(False):
        jax_lc = JaxLoopClosing(JaxMap(), JaxCamera(*cam_args), jax_tracker_factory("ORB2"),
                                "COSPLACE")
    lc = port_lc()
    r = np.random.default_rng(3)
    gdes = {kid: (v / np.linalg.norm(v)).astype(np.float32)
            for kid, v in zip((2, 5, 9), r.normal(size=(3, 128)))}
    for kid, g in gdes.items():
        lc.db.add(kid, None, g)
        jax_lc.db.add(kid, None, g)
    lc.num_loops_closed, lc.last_loop_kf_id = 1, 5
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    lc.save(str(tmp_path / "port"))
    jax_lc.save(str(tmp_path / "jax"))
    back = port_lc()
    assert back.load(str(tmp_path / "port"))
    assert back.db.kf_gdes.keys() == gdes.keys() and back.last_loop_kf_id == 5
    assert all(np.array_equal(back.db.kf_gdes[k], g) for k, g in gdes.items())
    assert all(len(back.db.kf_words[k]) == 0 for k in gdes)
    with jax.enable_x64(False):
        assert jax_lc.load(str(tmp_path / "port"))
    assert all(np.array_equal(jax_lc.db.kf_gdes[k], g) for k, g in gdes.items())
    other = port_lc()
    assert other.load(str(tmp_path / "jax"))
    assert all(np.array_equal(other.db.kf_gdes[k], g) for k, g in gdes.items())


@pytest.mark.parametrize("kind", ["uint8 grey", "float grey", "colour"])
def test_frame_keeps_the_vpr_images(vpr_flag, kind):
    """``Frame.img_thumb`` (average pooling to about 64x64) always, and
    ``img_vpr`` (every second pixel, uint8) under kRetainImageForVPR, as
    the JAX package's ``Frame`` keeps them; a 130x200 image."""
    from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
    from pyslam_tpu.slam.frame import Frame as JaxFrame
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.frame import Frame

    r = np.random.default_rng(6)
    img = r.uniform(0, 255, (130, 200, 3) if kind == "colour" else (130, 200))
    img = img.astype(np.uint8 if kind == "uint8 grey" else np.float32)
    cam_args = (200, 130, 100.0, 100.0, 100.0, 65.0)
    for retain in (False, True):
        JaxParameters.kRetainImageForVPR = Parameters.kRetainImageForVPR = retain
        ref = JaxFrame(JaxCamera(*cam_args), img=img)
        got = Frame(PinholeCamera(*cam_args), img=img)
        assert got.img_thumb.shape == (65, 66)
        assert np.array_equal(got.img_thumb, np.asarray(ref.img_thumb))
        if retain:
            assert got.img_vpr.dtype == np.uint8 and got.img_vpr.shape == (65, 100)
            assert np.array_equal(got.img_vpr, ref.img_vpr)
        else:
            assert got.img_vpr is None and ref.img_vpr is None
