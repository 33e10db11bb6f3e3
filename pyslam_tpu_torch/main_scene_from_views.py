"""Scene-from-views entry point of the port (counterpart of the JAX
package's ``main_scene_from_views.py``; reference: pySLAM
``main_scene_from_views.py``).

Reconstructs every third frame of the synthetic monocular line (step 0.5)
with one ``SceneFromViewsType`` backend and saves the poses and the point
cloud to an ``.npz``.

    python -m pyslam_tpu_torch.main_scene_from_views --type geometric --views 6 --save scene.npz

It runs on the card (``--device cuda``, the default) unless ``--device
cpu`` is given.  ``run`` returns the ``SceneFromViewsResult`` to callers.
"""

from __future__ import annotations

import argparse

import numpy as np

from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.main_slam import check_device
from pyslam_tpu_torch.scene_from_views.scene_from_views import scene_from_views_factory
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.utils.logging import Printer


def run(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pyslam_tpu_torch.main_scene_from_views")
    ap.add_argument("--type", default="geometric")
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--save", default="scene.npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(ap, args.device)

    ds = SyntheticDataset(num_frames=args.views * 3, sensor_type=SensorType.MONOCULAR,
                          trajectory="line", step=0.5)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    images = [ds.getImage(i * 3) for i in range(args.views)]

    sfv = scene_from_views_factory(args.type, camera=cam, device=device)
    result = sfv.reconstruct(images)
    Printer.blue(f"reconstructed {len(result.points)} points over {len(result.poses)} "
                 f"views (pairwise matches: {result.per_view_matches})")
    np.savez_compressed(args.save, poses=result.poses, points=result.points)
    Printer.green(f"saved -> {args.save}")
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
