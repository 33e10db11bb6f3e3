"""The depth estimators of the port (pyslam_tpu_torch/depth_estimation/
depth_estimator.py) against the JAX package's, built by both factories at
the small model sizes of tests/test_torch_depth_models.py (each module's
default configuration patched in both packages), the JAX weights carried
across, the JAX package run with x64 off.

Tolerances: ``infer``'s depth within ``TOL`` = 1e-4 of its largest
magnitude on every pixel that both packages keep valid, and the valid
masks equal on at least 99.9 % of the pixels (a threshold such as RAFT's
disparity > 0.5 px may fall either way at a float32 near-tie); the
back-projected points within ``TOL`` where valid.  The factory builds every
``DepthEstimatorType`` as the reference does; RAFT-Stereo and CREStereo
without a checkpoint are routed to SGM, with a flax ``.npz`` written by
the JAX package's ``save_variables_npz`` both packages load it and agree.

Each JAX model is built once for the module (``jax_models``): the JAX
factory runs on every call, its model classes patched to hand back the
model an earlier call built with the same arguments (the same
``PRNGKey(0)`` weights, as a fresh build would make), and each stereo
network's flax ``.npz`` is written once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyslam_tpu.depth_estimation import depth_estimator as JD
from pyslam_tpu.models import crestereo as jcre
from pyslam_tpu.models import depth_anything_v2 as jdav2
from pyslam_tpu.models import depth_anything as jdpt
from pyslam_tpu.models import depth_anything_v3 as jda3
from pyslam_tpu.models import depth_pro as jpro
from pyslam_tpu.models import mast3r as jmast3r
from pyslam_tpu.models import mvdust3r as jmv
from pyslam_tpu.models import raft_stereo as jraft
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.depth_estimation import depth_estimator as TD
from pyslam_tpu_torch.models import (crestereo, depth_anything_v2, depth_anything_v3, depth_pro,
                                     mast3r, mvdust3r, raft_stereo)
from pyslam_tpu_torch.slam.camera import PinholeCamera
from tests.test_torch_depth_models import (CRE_TINY, DA3_SMALL, DAV2_TINY, MV_SMALL, PRO_SMALL,
                                           RAFT_TINY)
from tests.torch_parity import compiled_flax_init, flat_variables, rng
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-4
MASK_SAME = 0.999
M_TINY = dict(img_hw=(64, 64), patch=16, enc_dim=32, enc_depth=2, enc_heads=2, dec_dim=48,
              dec_depth=2, dec_heads=2, desc_dim=8)
CAM = dict(width=96, height=72, fx=60.0, fy=60.0, cx=48.0, cy=36.0, bf=6.0)


# the JAX model classes the estimators build: (module, class name)
JAX_MODELS = ((jdav2, "DepthAnythingV2"), (jdpt, "DepthAnythingInference"),
              (jda3, "DepthAnything3"), (jpro, "DepthPro"), (jmv, "MVDust3rModel"),
              (jmast3r, "Mast3rModel"), (jraft, "RaftStereo"), (jcre, "CREStereo"))


@pytest.fixture(scope="module")
def jax_models():
    """The JAX models built so far in this module, by class and arguments."""
    return {}


@pytest.fixture
def small(monkeypatch, jax_models):
    """Both packages' default model configurations set to the small ones."""
    for jmod, tmod, name, kw in (
            (jdav2, depth_anything_v2, "DAv2Config", DAV2_TINY),
            (jda3, depth_anything_v3, "DA3Config", DA3_SMALL),
            (jmv, mvdust3r, "MVDust3rConfig", MV_SMALL),
            (jraft, raft_stereo, "RaftStereoConfig", RAFT_TINY),
            (jcre, crestereo, "CREStereoConfig", CRE_TINY),
            (jmast3r, mast3r, "Mast3rConfig", M_TINY)):
        for mod in (jmod, tmod):
            cls = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda cls=cls, kw=kw, **over: cls(**{**kw, **over}))
    for mod, name in JAX_MODELS:
        cls = getattr(mod, name)

        def once(*args, cls=cls, **kw):
            key = (cls.__name__, repr(args), repr(sorted(kw.items())))
            if key not in jax_models:
                jax_models[key] = cls(*args, **kw)
            return jax_models[key]

        monkeypatch.setattr(mod, name, once)
    return {"cfg_jax": jpro.DepthProConfig(**PRO_SMALL),
            "cfg_port": depth_pro.DepthProConfig(**PRO_SMALL)}


def _cams():
    return (JaxCamera(CAM["width"], CAM["height"], CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"],
                      bf=CAM["bf"]),
            PinholeCamera(CAM["width"], CAM["height"], CAM["fx"], CAM["fy"], CAM["cx"],
                          CAM["cy"], bf=CAM["bf"]))


def _pair(seed=0):
    r = rng(seed)
    tex = r.uniform(0, 255, (CAM["height"], CAM["width"] + 8)).astype(np.float32)
    return tex[:, 4:4 + CAM["width"]], tex[:, 1:1 + CAM["width"]]


def _assert_same_depth(got, want):
    (dg, pg), (dw, pw) = got, want
    assert dg.shape == dw.shape and dg.dtype == np.float32
    both = (dg > 0) & (dw > 0)
    assert ((dg > 0) == (dw > 0)).mean() >= MASK_SAME
    scale = max(float(np.abs(dw).max()), 1e-30)
    assert np.abs(dg[both] - dw[both]).max(initial=0.0) <= TOL * scale
    if pw is not None:
        assert pg.shape == pw.shape
        assert np.abs(pg[both] - pw[both]).max(initial=0.0) <= TOL * max(np.abs(pw).max(), 1e-30)


def _build(name, camera_pair=None, **kw):
    jcam, tcam = camera_pair or (None, None)
    jkw = {k: v for k, v in kw.items() if k != "cfg_port"}
    tkw = {k: v for k, v in kw.items() if k != "cfg_jax"}
    if "cfg_jax" in jkw:
        jkw["cfg"] = jkw.pop("cfg_jax")
    if "cfg_port" in tkw:
        tkw["cfg"] = tkw.pop("cfg_port")
    with jax.enable_x64(False), compiled_flax_init():
        ref = JD.depth_estimator_factory(name, camera=jcam, **jkw)
    got = TD.depth_estimator_factory(name, camera=tcam, device="cpu", **tkw)
    return ref, got


def _carry(ref, got, convert=interop.same_names_state_dict):
    got.model.net.load_state_dict(convert(flat_variables(ref.model.params)))


def _infer_both(ref, got, img, img_right=None):
    with jax.enable_x64(False):
        want = ref.infer(img, img_right=img_right)
    return got.infer(img, img_right=img_right), want


@pytest.mark.parametrize("faithful", [True, False])
def test_depth_anything(small, faithful):
    ref, got = _build("depth_anything_v2", _cams(), faithful=faithful)
    assert type(got.model).__name__ == type(ref.model).__name__
    _carry(ref, got)
    img = rng(1).uniform(0, 255, (CAM["height"], CAM["width"])).astype(np.float32)
    _assert_same_depth(*_infer_both(ref, got, img))


def test_depth_anything_v3(small):
    ref, got = _build("depth_anything_v3", _cams())
    _carry(ref, got)
    img = rng(2).uniform(0, 255, (CAM["height"], CAM["width"], 3)).astype(np.float32)
    _assert_same_depth(*_infer_both(ref, got, img))


@pytest.mark.parametrize("with_camera", [True, False])
def test_depth_pro(small, with_camera):
    ref, got = _build("depth_pro", _cams() if with_camera else None, cfg_jax=small["cfg_jax"],
                      cfg_port=small["cfg_port"])
    _carry(ref, got)
    img = rng(3).uniform(0, 255, (CAM["height"], CAM["width"])).astype(np.float32)
    _assert_same_depth(*_infer_both(ref, got, img))


@pytest.mark.parametrize("stereo", [False, True])
def test_mvdust3r(small, stereo):
    ref, got = _build("mvdust3r", _cams())
    _carry(ref, got)
    left, right = _pair(4)
    _assert_same_depth(*_infer_both(ref, got, left, right if stereo else None))


@pytest.mark.parametrize("stereo", [False, True])
def test_mast3r(small, stereo):
    ref, got = _build("mast3r", _cams())
    _carry(ref, got, interop.mast3r_state_dict)
    left, right = _pair(5)
    _assert_same_depth(*_infer_both(ref, got, left, right if stereo else None))


@pytest.fixture(scope="module")
def flax_npz(tmp_path_factory):
    """A flax ``.npz`` of each stereo network's own random weights
    (``PRNGKey(7)``) at the small size, written by the JAX package's
    ``save_variables_npz``."""
    from pyslam_tpu.models.torch_convert import save_variables_npz

    out = {}
    for net_name, net, cfg in (("raft_stereo", jraft.RaftStereoNet,
                                jraft.RaftStereoConfig(**RAFT_TINY)),
                               ("crestereo", jcre.CREStereoNet, jcre.CREStereoConfig(**CRE_TINY))):
        with jax.enable_x64(False), compiled_flax_init():
            params = net(cfg).init(jax.random.PRNGKey(7), jnp.zeros((48, 64)),
                                   jnp.zeros((48, 64)))
        out[net_name] = str(tmp_path_factory.mktemp("npz") / f"{net_name}.npz")
        save_variables_npz(out[net_name], params)
    return out


@pytest.mark.parametrize("name,cls", [("raft_stereo", "DepthEstimatorRaft"),
                                      ("crestereo", "DepthEstimatorCREStereo"),
                                      ("crestereo_megengine", "DepthEstimatorCREStereo")])
def test_stereo_networks_with_a_flax_npz(small, flax_npz, name, cls):
    """A flax ``.npz`` of the JAX package's own random weights, written by
    its ``save_variables_npz``, loads into both packages' estimators."""
    ckpt = flax_npz["raft_stereo" if name == "raft_stereo" else "crestereo"]
    # the reference's estimator fixes its CREStereo graph at 240 x 320
    cams = (JaxCamera(320, 240, 200.0, 200.0, 160.0, 120.0, bf=20.0),
            PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0, bf=20.0))
    ref, got = _build(name, cams, checkpoint=ckpt)
    assert type(got).__name__ == type(ref).__name__ == cls
    assert got.model.trained
    tex = rng(6).uniform(0, 255, (240, 330)).astype(np.float32)
    _assert_same_depth(*_infer_both(ref, got, tex[:, 6:326], tex[:, 1:321]))


def test_factory_builds_every_type(small):
    """Every ``DepthEstimatorType`` to the reference's class; the stereo
    networks without a checkpoint to SGM; each model's weights on the
    estimator's device."""
    jcam, tcam = _cams()
    for t in TD.DepthEstimatorType:
        kw = {"cfg": small["cfg_port"]} if t.value == "depth_pro" else {}
        got = TD.depth_estimator_factory(t.value, camera=tcam, device="cpu", **kw)
        jkw = {"cfg": small["cfg_jax"]} if t.value == "depth_pro" else {}
        with jax.enable_x64(False), compiled_flax_init():
            ref = JD.depth_estimator_factory(t.value, camera=jcam, **jkw)
        assert type(got).__name__ == type(ref).__name__, t
        assert got.device.type == "cpu"
        model = getattr(got, "model", None)
        if model is not None:
            assert not model.trained
            assert all(p.device.type == "cpu" for p in model.net.parameters())
