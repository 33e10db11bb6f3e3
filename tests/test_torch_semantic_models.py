"""The semantic models of the port (pyslam_tpu_torch/models/{deeplabv3,
segformer,clip,yolo_seg,detr}.py) against the JAX package's, with its
``PRNGKey(0)`` weights carried across (``interop.*_state_dict``), the JAX
package run with x64 off, at small sizes: DeepLabV3 over ResNet-18 on a
64x80 canvas (tests/test_torch_semantic_deeplab.py), SegFormer at 64x96, CLIP at the small configuration of
tests/test_semantic_backends.py, YOLO-seg at 128 px and width 8, DETR at
128 px, dim 64, one encoder and one decoder layer.

Then each backend of pyslam_tpu_torch/semantics/semantic_segmentation.py
through ``semantic_segmentation_factory`` against the JAX package's, over
the same models (each package's model class patched to give the one built
above, so the flax initialisations run once), and the entry point
``main_semantic_image_segmentation``.

Tolerances: every map, logit, embedding, box and mask within ``TOL`` =
1e-4 of its largest magnitude (``rel_err``); labels identical except where
the two largest logits (or scores, or CLIP similarities) are within
``TOL`` of the largest magnitude (a float32 near-tie either side may
round to its side); the tokenizer, YOLO's top-k cell order, classes and
NMS keep-list identical; checkpoints read by both packages give the same
weights.  INTENSITY_BANDS labels and probabilities identical; the YOLO-seg,
DETR and Detic label maps and instance classes identical (Detic's CLIP
crop classes too); the port's CLIP softmax (the maximum subtracted first,
a declared departure) equal to the reference's ``exp(sim / T)`` within
1e-6 wherever that is finite, and finite where it overflows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.models import clip as jclip
from pyslam_tpu.models import detr as jdetr
from pyslam_tpu.models import segformer as jseg
from pyslam_tpu.models import yolo_seg as jyolo
from pyslam_tpu.semantics import semantic_segmentation as jsemseg
from pyslam_tpu_torch import interop
from pyslam_tpu_torch.models import clip, deeplabv3, detr, segformer, yolo_seg
from pyslam_tpu_torch.semantics import semantic_segmentation as semseg
from tests.torch_parity import compiled_flax_init, flat_variables, np_, rel_err, rng
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

TOL = 1e-4
CLIP_SMALL = dict(img_px=64, vit_patch=16, vit_dim=48, vit_depth=2, vit_heads=4, text_dim=32,
                  text_depth=2, text_heads=4, embed_dim=32)
YOLO_SMALL = dict(img_px=128, width=8, num_classes=4, topk_per_level=16, max_det=8)
DETR_SMALL = dict(img_px=128, dim=64, heads=4, enc_depth=1, dec_depth=1, num_queries=8,
                  num_classes=4)


def _image(seed, h=96, w=128):
    im = rng(seed).uniform(0, 255, (h, w, 3)).astype(np.float32)
    im[h // 5:h // 2, w // 4:3 * w // 4] += 60
    return np.clip(im, 0, 255)


def assert_labels_but_near_ties(got, want, scores, axis=-1):
    """Labels identical except where the two largest ``scores`` along
    ``axis`` are within TOL of the largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    top2 = np.sort(np.moveaxis(np.asarray(scores), axis, -1), -1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] <= TOL * np.abs(scores).max()
    differ = got != want
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert differ.mean() <= 0.01


# ---------------------------------------------------------------- SegFormer
@pytest.fixture(scope="module")
def segf():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jseg.SegFormerInference(num_classes=7)
    got = segformer.SegFormerInference(num_classes=7, device="cpu")
    got.net.load_state_dict(interop.segformer_state_dict(flat_variables(ref.params)))
    return ref, got


def test_segformer_infer(segf):
    ref, got = segf
    img = _image(5, 66, 98)[..., 0]                    # grey, cropped to 64x96
    with jax.enable_x64(False):
        want = ref.infer(img)
    out = got.infer(img)
    assert out["labels"].shape == (66, 98) and (out["probs"][64:] == 0).all()
    assert rel_err(out["probs"], want["probs"]) <= TOL
    logits = np_(got.logits(img))
    assert logits.shape == (7, 64, 96)
    assert_labels_but_near_ties(out["labels"][:64, :96], want["labels"][:64, :96], logits,
                                axis=0)


def test_segformer_checkpoint(segf, tmp_path):
    """The JAX package's ``.npz`` (values in the sorted order of its keys,
    leaf by leaf of the flax tree) loads into both packages alike."""
    ref, got = segf
    leaves = jax.tree_util.tree_leaves(ref.params)
    r = rng(6)
    path = str(tmp_path / "segformer.npz")
    np.savez(path, **{f"w{i:03d}": r.normal(0, 0.1, np.shape(v)).astype(np.float32)
                      for i, v in enumerate(leaves)})
    with jax.enable_x64(False), compiled_flax_init():
        jref = jseg.SegFormerInference(num_classes=7, checkpoint=path)
    port = segformer.SegFormerInference(num_classes=7, checkpoint=path, device="cpu")
    assert port.trained
    want = interop.segformer_state_dict(flat_variables(jref.params))
    for k, v in port.net.state_dict().items():
        assert torch.equal(v, want[k]), k


# --------------------------------------------------------------------- CLIP
@pytest.fixture(scope="module")
def clip_pair():
    cfg = jclip.CLIPConfig(**CLIP_SMALL)
    with jax.enable_x64(False), compiled_flax_init():
        ref = jclip.CLIPModel(cfg)
    got = clip.CLIPModel(clip.CLIPConfig(**CLIP_SMALL), device="cpu")
    got.image.load_state_dict(interop.clip_state_dict(flat_variables(ref.image_params)))
    got.text.load_state_dict(interop.clip_state_dict(flat_variables(ref.text_params)))
    return ref, got


def test_clip_tokenizer():
    texts = ["a chair", "A Chair ", "a very different long text " * 3, "", "café"]
    np.testing.assert_array_equal(clip.tokenize(texts), jclip.tokenize(texts))
    np.testing.assert_array_equal(clip.tokenize(texts, 8), jclip.tokenize(texts, 8))


def test_clip_towers(clip_pair):
    ref, got = clip_pair
    texts = ["a photo of a chair", "a photo of a table", "wall"]
    with jax.enable_x64(False):
        want_t = ref.encode_text(texts)
        want_g, want_p = ref.encode_image(_image(7, 80, 90), dense=True)
        want_1 = ref.encode_image(_image(8, 40, 50)[..., 1])
    assert rel_err(got.encode_text(texts), want_t) <= TOL
    g, p = got.encode_image(_image(7, 80, 90), dense=True)
    assert p.shape == (4, 4, 32)
    assert rel_err(g, want_g) <= TOL and rel_err(p, want_p) <= TOL
    np.testing.assert_array_equal(got._prep(_image(8, 40, 50)[..., 1]),
                                  np.asarray(ref._prep(_image(8, 40, 50)[..., 1]), np.float32))
    assert rel_err(got.encode_image(_image(8, 40, 50)[..., 1]), want_1) <= TOL


def test_clip_checkpoint(clip_pair, tmp_path):
    """``<path>.image.npz`` / ``<path>.text.npz``, as the JAX package saves
    them, load into the port."""
    from pyslam_tpu.models.torch_convert import save_variables_npz

    ref, _ = clip_pair
    base = str(tmp_path / "clip")
    save_variables_npz(base + ".image.npz", ref.image_params)
    save_variables_npz(base + ".text.npz", ref.text_params)
    got = clip.CLIPModel(clip.CLIPConfig(**CLIP_SMALL), checkpoint=base, device="cpu")
    assert got.trained
    with jax.enable_x64(False):
        want = ref.encode_text(["a photo of a door"])
    assert rel_err(got.encode_text(["a photo of a door"]), want) <= TOL


# ----------------------------------------------------------------- YOLO-seg
@pytest.fixture(scope="module")
def yolo():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jyolo.YoloSeg(jyolo.YoloSegConfig(**YOLO_SMALL))
    got = yolo_seg.YoloSeg(yolo_seg.YoloSegConfig(**YOLO_SMALL), device="cpu")
    got.net.load_state_dict(interop.yolo_seg_state_dict(flat_variables(ref.params)))
    return ref, got


def test_yolo_heads_and_decode(yolo):
    ref, got = yolo
    x = got.prepare(_image(9))
    assert x.shape == (128, 128, 3)
    with jax.enable_x64(False):
        outs, proto = jax.jit(ref.net.apply)(ref.params, jnp.asarray(x))
        want = [np.asarray(o) for o in ref._run(ref.params, jnp.asarray(x))]
    with torch.no_grad():
        gouts, gproto = got.net(torch.from_numpy(x))
    assert rel_err(gproto.permute(1, 2, 0), proto) <= TOL
    for (c, b, m), (jc, jb, jm) in zip(gouts, outs):
        for a, j in ((c, jc), (b, jb), (m, jm)):
            assert rel_err(a.permute(1, 2, 0), j) <= TOL
    scores, labels, boxes, masks = (np_(o) for o in got.run(x))
    assert rel_err(scores, want[0]) <= TOL
    np.testing.assert_array_equal(labels, want[1])
    assert rel_err(boxes, want[2]) <= TOL and rel_err(masks, want[3]) <= TOL
    keep = got._nms(boxes, scores, max_det=8)
    np.testing.assert_array_equal(keep, ref._nms(want[2], want[0], max_det=8))


def test_yolo_infer(yolo):
    ref, got = yolo
    img = _image(10)
    with jax.enable_x64(False):
        want = ref.infer(img, score_thr=0.2)
    out = got.infer(img, score_thr=0.2)
    np.testing.assert_array_equal(out["labels"], want["labels"])
    np.testing.assert_array_equal(out["instances"]["classes"], want["instances"]["classes"])
    assert rel_err(out["instances"]["boxes"], want["instances"]["boxes"]) <= TOL
    assert len(out["instances"]["scores"]) > 0


# --------------------------------------------------------------------- DETR
@pytest.fixture(scope="module")
def detr_pair():
    with jax.enable_x64(False), compiled_flax_init():
        ref = jdetr.DetrModel(jdetr.DetrConfig(**DETR_SMALL))
    got = detr.DetrModel(detr.DetrConfig(**DETR_SMALL), device="cpu")
    got.net.load_state_dict(interop.detr_state_dict(flat_variables(ref.params)))
    return ref, got


def test_detr_forward_and_infer(detr_pair):
    ref, got = detr_pair
    np.testing.assert_array_equal(detr.sine_pos_2d(8, 8, 64),
                                  np.asarray(jdetr.sine_pos_2d(8, 8, 64)))
    img = _image(11)
    x = got.prepare(img)
    with jax.enable_x64(False):
        want = [np.asarray(o) for o in ref._run(ref.params, jnp.asarray(x))]
        want_inf = ref.infer(img, score_thr=0.1)
    out = [np_(o) for o in got.run(x)]
    assert out[2].shape == (8, 32, 32)
    for a, j in zip(out, want):
        assert rel_err(a, j) <= TOL
    inf = got.infer(img, score_thr=0.1)
    np.testing.assert_array_equal(inf["instances"]["classes"], want_inf["instances"]["classes"])
    np.testing.assert_array_equal(inf["labels"], want_inf["labels"])


# ----------------------------------------------------------------- backends
def _built(mp, pairs):
    """Patch each (module, class name, object): the class gives the object."""
    for mod, name, obj in pairs:
        mp.setattr(mod, name, lambda *a, _o=obj, **k: _o)


@pytest.fixture(scope="module")
def img():
    return _image(0)


def test_intensity_bands_identical(img):
    for nc in (5, 19):
        ref = jsemseg.semantic_segmentation_factory("intensity_bands", num_classes=nc)
        got = semseg.semantic_segmentation_factory("intensity_bands", num_classes=nc)
        assert got.device is None and got.class_names == ref.class_names
        for x in (img[..., 0], img[..., 0] * 1.01):
            a, b = got.infer(x), ref.infer(x)
            np.testing.assert_array_equal(a["labels"], b["labels"])
            np.testing.assert_array_equal(a["probs"], b["probs"])


def test_clip_segmentation(clip_pair, img):
    jm, m = clip_pair
    labels = ["wall", "floor", "chair"]
    with pytest.MonkeyPatch.context() as mp:
        _built(mp, [(jclip, "CLIPModel", jm), (clip, "CLIPModel", m)])
        with jax.enable_x64(False):
            ref = jsemseg.semantic_segmentation_factory("clip", labels=labels)
        got = semseg.semantic_segmentation_factory("clip", labels=labels, device="cpu")
    assert isinstance(got, semseg.CLIPOpenVocabSegmentation)
    assert got.class_names == ref.class_names and got.num_classes == 3
    assert rel_err(got.text_emb, ref.text_emb) <= TOL
    with jax.enable_x64(False):
        want = ref.infer(img)
    out = got.infer(img)
    assert out["labels"].dtype == np.int32 and out["labels"].shape == (96, 128)
    assert np.isfinite(want["probs"]).all()
    assert rel_err(out["probs"], want["probs"]) <= TOL
    assert rel_err(out["embeddings"], want["embeddings"]) <= TOL
    assert_labels_but_near_ties(out["labels"], want["labels"], out["embeddings"] @ got.text_emb.T)
    got.set_labels(["sky", "road"])                      # another label set, grey input
    with jax.enable_x64(False):
        ref.set_labels(["sky", "road"])
        want = ref.infer(img[..., 0])
    out = got.infer(img[..., 0])
    assert_labels_but_near_ties(out["labels"], want["labels"], out["embeddings"] @ got.text_emb.T)


def test_clip_softmax_departure():
    """The reference's ``exp(sim / T)`` overflows float32 above a cosine
    of ~0.887 at T = 0.01; the port subtracts the maximum first and agrees
    wherever the reference is finite."""
    sim = rng(1).uniform(-0.6, 0.85, (6, 6, 4)).astype(np.float32)
    sim[0, 0] = [0.95, 0.2, 0.1, 0.93]                  # the reference overflows here
    T = 0.01
    with np.errstate(over="ignore", invalid="ignore"):
        want = np.exp(sim / T)
        want /= want.sum(-1, keepdims=True)
    got = semseg.patch_softmax(sim, T)
    finite = np.isfinite(want).all(-1)
    assert not finite[0, 0] and finite.sum() == 35
    assert np.abs(got[finite] - want[finite]).max() <= 1e-6
    assert np.isfinite(got).all() and np.allclose(got.sum(-1), 1.0, atol=1e-6)
    assert got[0, 0].argmax() == 0


def test_yolo_and_detr_backends(yolo, detr_pair, img):
    with pytest.MonkeyPatch.context() as mp:
        _built(mp, [(jyolo, "YoloSeg", yolo[0]), (yolo_seg, "YoloSeg", yolo[1]),
                    (jdetr, "DetrModel", detr_pair[0]), (detr, "DetrModel", detr_pair[1])])
        pairs = [(jsemseg.semantic_segmentation_factory(kind, num_classes=4, score_thr=thr),
                  semseg.semantic_segmentation_factory(kind, num_classes=4, score_thr=thr,
                                                       device="cpu"))
                 for kind, thr in (("yolo", 0.2), ("rf_detr", 0.1))]
    for ref, got in pairs:
        assert got.num_classes == ref.num_classes == 5
        with jax.enable_x64(False):
            want = ref.infer(img)
        out = got.infer(img)
        np.testing.assert_array_equal(out["labels"], want["labels"])
        np.testing.assert_array_equal(out["instances"]["classes"], want["instances"]["classes"])
        assert out["labels"].min() >= 0 and out["labels"].max() < 5


def test_detic_backend(yolo, clip_pair, img):
    """Detic over the same proposals (YOLO-seg's classes ignored) and CLIP."""
    kw = dict(labels=["chair", "screen"], score_thr=0.05)
    with pytest.MonkeyPatch.context() as mp:
        _built(mp, [(jyolo, "YoloSeg", yolo[0]), (yolo_seg, "YoloSeg", yolo[1]),
                    (jclip, "CLIPModel", clip_pair[0]), (clip, "CLIPModel", clip_pair[1])])
        with jax.enable_x64(False):
            ref = jsemseg.semantic_segmentation_factory("detic", **kw)
        got = semseg.semantic_segmentation_factory("detic", device="cpu", **kw)
    with jax.enable_x64(False):
        want = ref.infer(img)
    out = got.infer(img)
    assert got.class_names == ref.class_names and len(want["instances"]["scores"]) > 0
    assert (np.asarray(want["instances"]["clip_classes"]) >= 0).any()
    np.testing.assert_array_equal(out["instances"]["classes"], want["instances"]["classes"])
    np.testing.assert_array_equal(out["instances"]["clip_classes"],
                                  want["instances"]["clip_classes"])
    np.testing.assert_array_equal(out["labels"], want["labels"])


def test_segformer_and_deeplab_through_the_factory(segf, img):
    with pytest.MonkeyPatch.context() as mp:
        _built(mp, [(jseg, "SegFormerInference", segf[0]),
                    (segformer, "SegFormerInference", segf[1])])
        ref = jsemseg.semantic_segmentation_factory("segformer", num_classes=7)
        got = semseg.semantic_segmentation_factory("segformer", num_classes=7, device="cpu")
    with jax.enable_x64(False):
        want = ref.infer(img)
    out = got.infer(img)
    assert rel_err(out["probs"], want["probs"]) <= TOL
    assert_labels_but_near_ties(out["labels"], want["labels"], out["probs"])
    dl = semseg.semantic_segmentation_factory("deeplabv3", device="cpu")
    assert isinstance(dl, deeplabv3.DeepLabV3Segmenter) and dl.num_classes == 21
    assert dl.net.backbone.arch == "resnet50" and not dl.trained
    with pytest.raises(ValueError):
        semseg.semantic_segmentation_factory("no_such_backend")


def test_main_semantic_image_segmentation():
    from pyslam_tpu_torch import main_semantic_image_segmentation as entry

    rows = entry.run(["--device", "cpu", "--frames", "2"])
    assert [r["frame"] for r in rows] == [0, 1] and all(r["num_classes"] >= 2 for r in rows)
    rows = entry.run(["--device", "cpu", "--frames", "1", "--backend", "segformer"])
    assert rows[0]["num_classes"] >= 1
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:            # the card by default, no fall back
            entry.main(["--frames", "1"])
        assert e.value.code == 2
