"""Feature extraction and matching of two images, the port's entry point
(counterpart of the JAX package's ``main_feature_matching.py``; reference:
pySLAM ``main_feature_matching.py``).

    python -m pyslam_tpu_torch.main_feature_matching                    # synthetic frames 0, 2
    python -m pyslam_tpu_torch.main_feature_matching --img1 A --img2 B --features SIFT

Extracts both images with a tracker preset, matches them with the preset's
matcher and prints the keypoint counts, the match count and the median
displacement, as the JAX package's entry point does.  It runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given.
``--features`` names a tracker preset at ``--num_features`` (ORB2 and FAST
on 4 levels), as the port's ``main_vo`` resolves it; the JAX package
builds ``FeatureTrackerConfig(name=...)`` and so runs ORB2 whatever it is
given.  The detector-free LOFTR has no per-image extraction: its
``detectAndCompute`` raises, as the reference tracker's does.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from pyslam_tpu_torch.features.tracker import (
    FeatureTrackerConfig,
    FeatureTrackerConfigs,
    feature_tracker_factory,
)
from pyslam_tpu_torch.main_slam import check_device
from pyslam_tpu_torch.utils.logging import Printer


def load_pair(args):
    if args.img1 and args.img2:
        from pyslam_tpu_torch.io.dataset import _imread_gray

        return _imread_gray(args.img1), _imread_gray(args.img2)
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=5, sensor_type=SensorType.MONOCULAR)
    return ds.getImage(0), ds.getImage(2)


def tracker_config(name: str, num_features: int) -> FeatureTrackerConfig:
    """The preset ``name`` at ``num_features`` (ORB2 and FAST on 4 levels);
    an unknown name is an ORB2 tracker under that name."""
    try:
        cfg = dataclasses.replace(FeatureTrackerConfigs.get(name), num_features=num_features)
    except KeyError:
        return FeatureTrackerConfig(name=name, num_features=num_features, num_levels=4)
    if cfg.detector_type.name in ("ORB2", "FAST") and cfg.tracker_type.name not in (
            "LOFTR", "MAST3R"):
        cfg = dataclasses.replace(cfg, num_levels=4)
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pyslam_tpu_torch.main_feature_matching")
    ap.add_argument("--img1", default=None)
    ap.add_argument("--img2", default=None)
    ap.add_argument("--features", default="ORB2")
    ap.add_argument("--num_features", type=int, default=1000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(ap, args.device)

    img1, img2 = load_pair(args)
    tracker = feature_tracker_factory(tracker_config(args.features, args.num_features),
                                      device=device)
    f1 = tracker.detectAndCompute(img1)
    f2 = tracker.detectAndCompute(img2)
    i1, i2 = tracker.match(f1, f2)
    n1 = int(f1.valid.sum())
    n2 = int(f2.valid.sum())
    Printer.green(f"keypoints: {n1} / {n2}")
    Printer.green(f"matches: {len(i1)}")
    if len(i1):
        d = f2.xy.cpu().numpy()[i2] - f1.xy.cpu().numpy()[i1]
        Printer.blue(f"median displacement: {np.median(d, 0).round(2)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
