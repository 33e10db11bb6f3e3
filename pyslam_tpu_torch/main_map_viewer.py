#!/usr/bin/env python3
"""Map viewer entry of the port (counterpart of the JAX package's
``main_map_viewer.py``; reference: pySLAM ``main_map_viewer.py``): load a
saved system state (either package's, either schema) and render the map
and trajectory views to a PNG (matplotlib, or rerun when it is
installed), and with ``--html`` the standalone interactive viewer.

    python -m pyslam_tpu_torch.main_map_viewer STATE_DIR [--out map_view.png]
        [--html map_view.html] [--device cpu]

The map is loaded on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.main_slam import check_device
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from pyslam_tpu_torch.utils.logging import Printer
from pyslam_tpu_torch.viz.viewer3d import Viewer3D


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pyslam_tpu_torch.main_map_viewer")
    ap.add_argument("state", help="saved system-state folder (map.json inside)")
    ap.add_argument("--out", default="map_view.png")
    ap.add_argument("--html", default=None, metavar="PATH",
                    help="also export the standalone interactive HTML viewer")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(ap, args.device)

    with open(os.path.join(args.state, "map.json")) as f:
        d = json.load(f)
    camera = PinholeCamera.from_json(d["camera"])
    slam = Slam(camera, FeatureTrackerConfig(),
                sensor_type=SensorType[d.get("sensor_type", "MONOCULAR")], device=device)
    slam.load_system_state(args.state)
    viewer = Viewer3D(backend="matplotlib", out_path=args.out)
    viewer.draw_map(slam)
    Printer.green(f"map view -> {args.out}")
    if args.html:
        viewer.export_html(slam, args.html)
        Printer.green(f"interactive viewer -> {args.html}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
