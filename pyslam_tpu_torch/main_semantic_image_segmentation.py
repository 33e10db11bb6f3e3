"""Semantic segmentation demo of the port (counterpart of the JAX
package's ``main_semantic_image_segmentation.py``; reference: pySLAM
``main_semantic_image_segmentation.py``).

Segments the frames of the synthetic monocular stream with a backend of
``semantic_segmentation_factory`` and prints, for each, the number of
classes present and the five largest.

    python -m pyslam_tpu_torch.main_semantic_image_segmentation --backend segformer --frames 3

The backend's network runs on the card (``--device cuda``, the default)
unless ``--device cpu`` is given.  ``run`` returns the per-frame results
(a list of dicts) for callers.
"""

from __future__ import annotations

import argparse

import numpy as np

from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.main_slam import check_device
from pyslam_tpu_torch.semantics.semantic_segmentation import semantic_segmentation_factory
from pyslam_tpu_torch.utils.logging import Printer


def run(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m pyslam_tpu_torch.main_semantic_image_segmentation")
    ap.add_argument("--backend", default="intensity_bands")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(ap, args.device)

    ds = SyntheticDataset(num_frames=args.frames, sensor_type=SensorType.MONOCULAR)
    seg = semantic_segmentation_factory(args.backend, device=device)
    out = []
    for i in range(args.frames):
        labels = seg.infer(ds.getImage(i))["labels"]
        labs, counts = np.unique(labels, return_counts=True)
        top = labs[np.argsort(-counts)][:5]
        Printer.green(f"frame {i}: {len(labs)} classes, top: {top.tolist()}")
        out.append({"frame": i, "num_classes": int(len(labs)), "top": top.tolist()})
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
