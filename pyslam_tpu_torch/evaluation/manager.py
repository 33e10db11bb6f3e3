"""Batch evaluation harness: dataset x preset grids with reports (port of
``pyslam_tpu/evaluation/manager.py``).

Reference: pySLAM ``pyslam/evaluation/slam_evaluation_manager.py:122-532``
(spawns headless main_slam runs over json-configured grids, N runs each,
aggregates ATE/max/%lost into CSV/LaTeX/HTML reports).  Here runs execute
in-process (the reference needed subprocesses for isolation of its global
state); the report writer emits CSV + markdown (and the LaTeX, HTML and PDF reports
of ``report_formats.py``).  Every run's ``Slam`` lives on the manager's
``device``.  The one-sequence-per-device grid of the JAX package
(``run_distributed``) waits with ``parallel/`` (ROADMAP.md item 4).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from pyslam_tpu_torch.evaluation.metrics import eval_ate
from pyslam_tpu_torch.evaluation.report_formats import (
    csv_list_to_html,
    csv_list_to_latex,
    csv_list_to_pdf,
)
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_factory import dataset_factory
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.ground_truth import groundtruth_factory
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from pyslam_tpu_torch.utils.logging import Printer


@dataclass
class EvalRunResult:
    dataset: str
    preset: str
    run: int
    ate_rmse: float
    ate_max: float
    percent_lost: float
    num_keyframes: int
    num_points: int
    duration_s: float


@dataclass
class EvalConfig:
    datasets: list = field(default_factory=list)   # list of dataset-settings dicts
    presets: dict = field(default_factory=dict)    # name -> FeatureTrackerConfig
    runs_per_dataset: int = 1
    loop_detector: str | None = "DBOW3"

    @staticmethod
    def from_json(path: str) -> "EvalConfig":
        with open(path) as f:
            d = json.load(f)
        presets = {
            name: FeatureTrackerConfig.from_json(cfg)
            for name, cfg in d.get("presets", {}).items()
        }
        return EvalConfig(
            datasets=d.get("datasets", []),
            presets=presets,
            runs_per_dataset=d.get("number_of_runs_per_dataset", 1),
            loop_detector=d.get("loop_detector", "DBOW3"),
        )


class SlamEvaluationManager:
    def __init__(self, config: EvalConfig, out_dir: str = "results/eval", *,
                 device: torch.device | str = "cuda"):
        self.config = config
        self.device = torch.device(device)
        self.out_dir = out_dir
        self.results: list[EvalRunResult] = []

    def run(self):
        for ds_settings in self.config.datasets:
            for preset_name, tracker_cfg in self.config.presets.items():
                for run in range(self.config.runs_per_dataset):
                    r = self._single_run(ds_settings, preset_name, tracker_cfg, run)
                    self.results.append(r)
                    Printer.green(
                        f"[eval] {r.dataset}/{r.preset} run {run}: "
                        f"ate={r.ate_rmse:.4f} lost={r.percent_lost:.2f}%"
                    )
        self.write_reports()
        return self.results

    def _single_run(self, ds_settings, preset_name, tracker_cfg, run) -> EvalRunResult:
        t0 = time.time()
        dataset = dataset_factory(ds_settings)
        gt = groundtruth_factory(
            ds_settings.get("groundtruth", {"type": "synthetic", "dataset": dataset})
        )
        sensor = dataset.sensor_type
        camera = ds_settings.get("camera")
        if isinstance(camera, dict):   # a json grid names the camera as to_json writes it
            camera = PinholeCamera.from_json(camera)
        if camera is None:
            camera = PinholeCamera(
                dataset.w, dataset.h, dataset.fx, dataset.fy, dataset.cx,
                dataset.cy, fps=dataset.fps,
                bf=dataset.fx * getattr(dataset, "baseline", 0.2),
                depth_threshold=20.0,
            )
        slam = Slam(camera, tracker_cfg,
                    loop_detector_config=self.config.loop_detector,
                    sensor_type=sensor, device=self.device)
        num_lost = 0
        for i in range(len(dataset)):
            slam.track(
                dataset.getImage(i), img_right=dataset.getImageRight(i),
                depth=dataset.getDepth(i), frame_id=i,
                timestamp=dataset.getTimestamp(i),
            )
            if slam.state.name != "OK":
                num_lost += 1
        ts, poses = slam.get_final_trajectory()
        if gt is not None and len(ts) > 3:
            res = eval_ate(ts, poses[:, :3, 3], gt.timestamps, gt.positions,
                           with_scale=(sensor == SensorType.MONOCULAR))
            rmse, mx = res.rmse, res.max
        else:
            rmse, mx = np.inf, np.inf
        return EvalRunResult(
            dataset=ds_settings.get("name", ds_settings.get("type", "?")),
            preset=preset_name,
            run=run,
            ate_rmse=rmse,
            ate_max=mx,
            percent_lost=100.0 * num_lost / max(len(dataset), 1),
            num_keyframes=slam.map.num_keyframes(),
            num_points=slam.map.num_points(),
            duration_s=time.time() - t0,
        )

    # --------------------------------------------------------------- reports
    def write_reports(self):
        os.makedirs(self.out_dir, exist_ok=True)
        # raw CSV
        with open(os.path.join(self.out_dir, "runs.csv"), "w") as f:
            f.write("dataset,preset,run,ate_rmse,ate_max,percent_lost,"
                    "num_keyframes,num_points,duration_s\n")
            for r in self.results:
                f.write(
                    f"{r.dataset},{r.preset},{r.run},{r.ate_rmse:.6f},"
                    f"{r.ate_max:.6f},{r.percent_lost:.3f},{r.num_keyframes},"
                    f"{r.num_points},{r.duration_s:.1f}\n"
                )
        # aggregated tables (mean over runs), reference-style table_rmse.csv
        agg: dict = {}
        for r in self.results:
            agg.setdefault((r.dataset, r.preset), []).append(r)
        presets = sorted({p for _, p in agg})
        datasets = sorted({d for d, _ in agg})
        for metric, fname in [("ate_rmse", "table_rmse.csv"),
                              ("percent_lost", "table_percent_lost.csv")]:
            with open(os.path.join(self.out_dir, fname), "w") as f:
                f.write("dataset," + ",".join(presets) + "\n")
                for d in datasets:
                    row = [d]
                    for p in presets:
                        rs = agg.get((d, p), [])
                        v = np.mean([getattr(x, metric) for x in rs]) if rs else np.nan
                        row.append(f"{v:.4f}")
                    f.write(",".join(row) + "\n")
        # markdown summary
        with open(os.path.join(self.out_dir, "report.md"), "w") as f:
            f.write("# SLAM evaluation report\n\n")
            f.write("| dataset | preset | ATE rmse | ATE max | % lost | KFs | points |\n")
            f.write("|---|---|---|---|---|---|---|\n")
            for (d, p), rs in sorted(agg.items()):
                f.write(
                    f"| {d} | {p} | "
                    f"{np.mean([r.ate_rmse for r in rs]):.4f} | "
                    f"{np.mean([r.ate_max for r in rs]):.4f} | "
                    f"{np.mean([r.percent_lost for r in rs]):.2f} | "
                    f"{int(np.mean([r.num_keyframes for r in rs]))} | "
                    f"{int(np.mean([r.num_points for r in rs]))} |\n"
                )
        # LaTeX / HTML / PDF comparative reports (reference
        # slam_evaluation_manager.py:574-596)
        tables = [os.path.join(self.out_dir, n)
                  for n in ("table_rmse.csv", "table_percent_lost.csv",
                            "runs.csv")]
        tables = [t for t in tables if os.path.exists(t)]
        csv_list_to_latex(tables, os.path.join(self.out_dir, "report.tex"))
        csv_list_to_html(tables, os.path.join(self.out_dir, "report.html"))
        csv_list_to_pdf(tables, os.path.join(self.out_dir, "report.pdf"))
        Printer.green(f"[eval] reports written to {self.out_dir}")
