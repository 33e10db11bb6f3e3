"""The semantic slice as a whole: a 12-frame stereo session (the 240x320
line stream of tests/test_semantics.py, 0.4 m a frame, 400 ORB2 features
on 4 levels) with a semantic mapper attached through
``Slam.set_semantic_mapping``, in both packages.  The mapper segments with
the weight-free intensity bands (19 classes, the Cityscapes information
weights), the left half of the image relabelled 8, 'vegetation' at 0.001
(the stream's grey levels fall in no band 8), and
``kUseSemanticsInOptimization`` is on.  Each frame is followed by a drained
back-end and mapper, as tests/test_semantics.py runs it, so both packages
hand each keyframe over in the frame that made it.

Held: the same frames tracked in both packages, and the same keyframes
(by frame id) but for at most one a package (measured: 0, 3, 7 and then 10
in the port, 11 in the JAX package; ORB2's slot order differs between the
packages at this size, which moves the last keyframe decision), each
labelled with the segmenter's label under each
rounded raw keypoint; ``kps_sem`` identical on every keypoint the two
packages' keyframes share (the slot order differs: ORB2's grid top-k
orders the slots otherwise); every valid point a labelled
keyframe observes has scores; in the local BA, with every keyframe's even
keypoints labelled 'vegetation', ``sigma2`` 1000 times larger on those
observations and unchanged elsewhere; the weighting changes the port's
keyframe trajectory; ``Slam.reset()`` points the mapper at the new map.
"""

import numpy as np
import pytest

from pyslam_tpu.config_parameters import Parameters as JaxParameters
from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
from pyslam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from pyslam_tpu.io.dataset_types import SensorType as JaxSensorType
from pyslam_tpu.semantics import semantic_mapping as jsm
from pyslam_tpu.semantics.semantic_segmentation import IntensityBandSegmentation as JaxBands
from pyslam_tpu.slam.camera import PinholeCamera as JaxCamera
from pyslam_tpu.slam.slam import Slam as JaxSlam
from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.semantics import semantic_mapping as sm
from pyslam_tpu_torch.semantics.semantic_segmentation import IntensityBandSegmentation
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from tests import torch_parity  # noqa: F401  (one small torch thread pool per worker)
from tests.torch_parity import shared_jax_compile_cache  # noqa: F401  (module fixture)

N_FRAMES = 12


def _half_vegetation(bands):
    """A segmenter class over a package's intensity bands: labels only,
    the left image half 'vegetation' (8)."""
    class HalfVegetation(bands):
        def infer(self, img):
            labels = super().infer(img)["labels"]
            labels[:, : labels.shape[1] // 2] = 8
            return {"labels": labels}

    return HalfVegetation(19)


def _session(pkg, use_sem: bool):
    if pkg == "jax":
        P, DS, ST, Cam, S, Cfg = (JaxParameters, JaxSyntheticDataset, JaxSensorType, JaxCamera,
                                  JaxSlam, JaxTrackerConfig)
        mapper = jsm.SemanticMappingDense
        mcfg = jsm.SemanticMappingConfig(num_classes=19, dataset="cityscapes")
        seg, kw = _half_vegetation(JaxBands), {}
    else:
        P, DS, ST, Cam, S, Cfg = (Parameters, SyntheticDataset, SensorType, PinholeCamera, Slam,
                                  FeatureTrackerConfig)
        mapper = sm.SemanticMappingDense
        mcfg = sm.SemanticMappingConfig(num_classes=19, dataset="cityscapes")
        seg, kw = _half_vegetation(IntensityBandSegmentation), {"device": "cpu"}
    ds = DS(num_frames=N_FRAMES, sensor_type=ST.STEREO, trajectory="line", step=0.4)
    cam = Cam(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps, bf=ds.fx * ds.baseline,
              depth_threshold=20.0)
    slam = S(cam, Cfg(num_features=400, num_levels=4), sensor_type=ST.STEREO, **kw)
    sem = mapper(slam.map, mcfg, segmenter=seg)
    slam.set_semantic_mapping(sem)
    old = P.kUseSemanticsInOptimization
    P.kUseSemanticsInOptimization = use_sem
    tracked, images = [], {}
    try:
        for i in range(N_FRAMES):
            n = len(slam.tracking.history.timestamps)
            images[i] = ds.getImage(i)
            slam.track(images[i], img_right=ds.getImageRight(i), frame_id=i,
                       timestamp=ds.getTimestamp(i))
            slam.local_mapping.finish()
            sem.run_all()
            if len(slam.tracking.history.timestamps) > n:
                tracked.append(i)
        slam.finish()
    finally:
        P.kUseSemanticsInOptimization = old
    return slam, sem, tracked, images


@pytest.fixture(scope="module")
def runs():
    return {"jax": _session("jax", True), "port": _session("port", True),
            "port_off": _session("port", False)}


def _kfs(slam):
    return {kf.id: kf for kf in slam.map.keyframes.values()}


def test_same_frames_keyframes_and_labels(runs):
    (jslam, _, jtracked, _), (slam, sem, tracked, images) = runs["jax"], runs["port"]
    assert tracked == jtracked == list(range(N_FRAMES))
    jk, pk = _kfs(jslam), _kfs(slam)
    assert len(set(pk) - set(jk)) <= 1 and len(set(jk) - set(pk)) <= 1
    assert len(set(pk) & set(jk)) >= 3
    assert all(k.kps_sem is not None for k in jk.values())
    shared = 0
    for fid, kf in pk.items():
        assert kf.kps_sem is not None
        labels = _half_vegetation(IntensityBandSegmentation).infer(images[fid])["labels"]
        h, w = labels.shape
        xs = np.clip(np.round(kf.kps_raw[:, 0]).astype(int), 0, w - 1)
        ys = np.clip(np.round(kf.kps_raw[:, 1]).astype(int), 0, h - 1)
        np.testing.assert_array_equal(kf.kps_sem, labels[ys, xs])
        if fid not in jk:
            continue
        ref = {tuple(xy): lab for xy, lab in zip(np.asarray(jk[fid].kps_raw).tolist(),
                                                 jk[fid].kps_sem.tolist())}
        both = [(lab, ref[tuple(xy)]) for xy, lab in zip(kf.kps_raw.tolist(),
                                                         kf.kps_sem.tolist())
                if tuple(xy) in ref]
        assert len(both) >= 0.8 * len(kf.kps_raw)
        assert all(a == b for a, b in both)
        shared += len(both)
    sems = np.concatenate([kf.kps_sem for kf in pk.values()])
    assert (sems == 8).any() and (sems != 8).any() and shared > 0
    for kf in pk.values():
        for pid in kf.points[kf.points >= 0]:
            if slam.map.points.valid[pid]:
                assert int(pid) in sem.point_scores


def test_semantic_ba_weighting(runs):
    """sigma2 is 1000 times larger on the 'vegetation' observations (class
    8, weight 0.001) and unchanged on the others."""
    slam = runs["port_off"][0]
    lm, kf = slam.local_mapping, slam.map.last_keyframe()
    for k in slam.map.keyframes.values():
        labels = np.zeros(len(k.kps), np.int64)
        labels[::2] = 8
        k.kps_sem = labels
    old = Parameters.kUseSemanticsInOptimization
    try:
        Parameters.kUseSemanticsInOptimization = False
        base, meta = lm._lba_build(kf)
        Parameters.kUseSemanticsInOptimization = True
        weighted, _ = lm._lba_build(kf)
    finally:
        Parameters.kUseSemanticsInOptimization = old
    n = len(meta["cam_idx"])
    ratio = (weighted.sigma2[:n] / base.sigma2[:n]).numpy()
    veg = np.isclose(ratio, 1000.0, rtol=1e-3)
    assert veg.any() and (veg | (ratio == 1.0)).all() and (~veg).any()


def test_weighting_changes_the_trajectory(runs):
    on, off = runs["port"][0], runs["port_off"][0]
    a, b = _kfs(off), _kfs(on)
    common = sorted(set(a) & set(b))
    assert len(common) >= 3
    assert max(np.abs(a[f].Tcw - b[f].Tcw).max() for f in common) > 1e-7


def test_reset_and_device_checks(runs):
    slam, sem = runs["port_off"][:2]
    slam.reset()
    assert sem.map is slam.map and not sem.point_scores and not sem.queue
    assert slam.map.point_removal_listeners == [sem._on_point_removed]

    class OnMeta(IntensityBandSegmentation):
        device = "meta"

    with pytest.raises(ValueError):
        slam.set_semantic_mapping(sm.SemanticMappingDense(slam.map, segmenter=OnMeta(8)))
