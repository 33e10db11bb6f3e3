"""Map/trajectory visualization.
(port of ``pyslam_tpu/viz/viewer3d.py``: the same code; matplotlib and rerun
are imported when a drawing needs them).

Reference: pySLAM ``pyslam/viz/viewer3D.py`` (pangolin GL viewer in a child
process) and the Rerun integration (``rerun_interface.py``).  GL/pangolin is
not available here; this module provides the same drawing surface over two
backends:

- matplotlib (headless PNG snapshots — trajectory, map points, covisibility
  edges, dense cloud),
- rerun (if the `rerun` SDK is importable; streamed live logging with the
  same entity paths as the reference's Rerun interface).

The SLAM loop calls ``draw_map`` at whatever cadence it likes; everything is
host-side and optional.
"""

from __future__ import annotations

import numpy as np


class Viewer3D:
    def __init__(self, backend: str = "auto", out_path: str = "map_view.png"):
        self.out_path = out_path
        self.backend = backend
        self._rerun = None
        if backend in ("auto", "rerun"):
            try:  # pragma: no cover - optional dependency
                import rerun as rr

                rr.init("pyslam_tpu", spawn=False)
                self._rerun = rr
                self.backend = "rerun"
            except Exception:
                self.backend = "matplotlib"
        if backend == "matplotlib":
            self.backend = "matplotlib"

    # ------------------------------------------------------------- drawing
    @staticmethod
    def _graph_edges(slam, covis_min_weight: int = 30):
        """(covisibility, spanning-tree, loop) line segments, like the
        reference viewer's checkbox-toggled graph layers."""
        centers = {}
        for kid in slam.map.keyframe_order:
            centers[kid] = np.asarray(slam.map.keyframes[kid].Ow)
        cov, span, loops = [], [], []
        for kid in slam.map.keyframe_order:
            kf = slam.map.keyframes[kid]
            for other, w in getattr(kf, "connected_keyframes", {}).items():
                if w >= covis_min_weight and other in centers and other > kid:
                    cov.append((centers[kid], centers[other]))
            parent = getattr(kf, "parent", None)
            if parent is not None and parent in centers:
                span.append((centers[kid], centers[parent]))
            for other in getattr(kf, "loop_edges", ()):
                if other in centers and other > kid:
                    loops.append((centers[kid], centers[other]))
        return cov, span, loops

    def draw_map(self, slam, dense_points=None, gt_positions=None):
        st = slam.map.points
        pids = st.alive_ids()
        pts = st.pos[pids]
        kf_centers = np.array(
            [slam.map.keyframes[k].Ow for k in slam.map.keyframe_order]
        ) if slam.map.keyframe_order else np.zeros((0, 3))
        ts, poses = slam.get_final_trajectory()
        traj = poses[:, :3, 3] if len(ts) else np.zeros((0, 3))
        edges = self._graph_edges(slam)
        if self.backend == "rerun":
            self._draw_rerun(slam, pts, kf_centers, traj, dense_points, edges)
        else:
            self._draw_matplotlib(pts, kf_centers, traj, dense_points,
                                  gt_positions, edges)

    def export_html(self, slam, out_path: str = "map_view.html",
                    dense_points=None):
        """Standalone interactive viewer (viz/html_viewer.py)."""
        from pyslam_tpu_torch.viz.html_viewer import export_html_map

        return export_html_map(slam, out_path, dense_points=dense_points)

    def _draw_rerun(self, slam, pts, kf_centers, traj, dense_points,
                    edges):  # pragma: no cover
        rr = self._rerun
        rr.log("map/points", rr.Points3D(pts, radii=0.01))
        rr.log("map/keyframes", rr.Points3D(kf_centers, radii=0.05))
        if len(traj):
            rr.log("map/trajectory", rr.LineStrips3D([traj]))
        if dense_points is not None:
            rr.log("map/dense", rr.Points3D(dense_points, radii=0.01))
        cov, span, loops = edges
        for name, segs, color in (("covisibility", cov, (90, 90, 90)),
                                  ("spanning_tree", span, (40, 160, 40)),
                                  ("loops", loops, (220, 50, 50))):
            if segs:
                rr.log(f"map/graph/{name}",
                       rr.LineStrips3D([np.stack(s) for s in segs],
                                       colors=color))
        # camera poses as pinhole frusta (reference rerun_interface logs
        # the same entity layout)
        for kid in slam.map.keyframe_order[-1:]:
            kf = slam.map.keyframes[kid]
            rr.log("map/camera",
                   rr.Transform3D(translation=kf.Twc[:3, 3],
                                  mat3x3=kf.Twc[:3, :3]))

    def _draw_matplotlib(self, pts, kf_centers, traj, dense_points,
                         gt_positions, edges=((), (), ())):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        cov, span, loops = edges
        fig, axes = plt.subplots(1, 2, figsize=(14, 7))
        # top-down (x-z) and side (x-y)
        for ax, (a, b), name in zip(axes, [(0, 2), (0, 1)], ["top (x-z)", "side (x-y)"]):
            for segs, color, lw in ((cov, "#bbbbbb", 0.3),
                                    (span, "#2d8a2d", 0.8),
                                    (loops, "#d33", 1.2)):
                for p, q in segs:
                    ax.plot([p[a], q[a]], [p[b], q[b]], color=color, lw=lw)
            if len(pts):
                ax.scatter(pts[:, a], pts[:, b], s=1, c="gray", alpha=0.4,
                           label="map points")
            if dense_points is not None and len(dense_points):
                ax.scatter(dense_points[:, a], dense_points[:, b], s=0.5,
                           c="lightblue", alpha=0.2)
            if len(traj):
                ax.plot(traj[:, a], traj[:, b], "b-", lw=1.5, label="trajectory")
            if gt_positions is not None and len(gt_positions):
                ax.plot(gt_positions[:, a], gt_positions[:, b], "g--", lw=1,
                        label="ground truth")
            if len(kf_centers):
                ax.scatter(kf_centers[:, a], kf_centers[:, b], s=12, c="red",
                           marker="s", label="keyframes")
            ax.set_title(name)
            ax.set_aspect("equal")
            ax.legend(loc="best", fontsize=8)
        fig.tight_layout()
        fig.savefig(self.out_path, dpi=110)
        plt.close(fig)

    def quit(self):
        pass


class SlamPlotDrawer:
    """2D diagnostic plots (reference ``slam_plot_drawer.py``): per-frame
    matched/inlier counts and timing curves, written as PNG."""

    def __init__(self, out_path: str = "slam_plots.png"):
        self.out_path = out_path
        self.frames: list[int] = []
        self.matched: list[int] = []
        self.inliers: list[int] = []
        self.fps: list[float] = []
        self.timing_curves: dict[str, list[float]] = {}

    def add(self, frame_id, num_matched, num_inliers, fps=0.0, timings=None):
        self.frames.append(frame_id)
        self.matched.append(num_matched)
        self.inliers.append(num_inliers)
        self.fps.append(fps)
        if timings:
            # flatten {'module': {'stage': {'last_ms': ...}}} into curves
            for mod, stages in timings.items():
                for st, v in stages.items():
                    key = f"{mod}.{st}"
                    curve = self.timing_curves.setdefault(
                        key, [float("nan")] * (len(self.frames) - 1))
                    curve.append(v["last_ms"])
            for curve in self.timing_curves.values():
                while len(curve) < len(self.frames):
                    curve.append(float("nan"))

    def save(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        rows = 3 if self.timing_curves else 2
        fig, axes = plt.subplots(rows, 1, figsize=(10, 3 * rows),
                                 sharex=True)
        axes[0].plot(self.frames, self.matched, label="matched")
        axes[0].plot(self.frames, self.inliers, label="inliers")
        axes[0].legend()
        axes[0].set_ylabel("count")
        axes[1].plot(self.frames, self.fps, label="fps")
        axes[1].set_ylabel("fps")
        if self.timing_curves:
            for key, curve in sorted(self.timing_curves.items()):
                axes[2].plot(self.frames[: len(curve)], curve,
                             label=key, lw=0.8)
            axes[2].set_ylabel("stage ms")
            axes[2].set_yscale("log")
            axes[2].legend(fontsize=6, ncol=2)
        axes[-1].set_xlabel("frame")
        fig.tight_layout()
        fig.savefig(self.out_path, dpi=110)
        plt.close(fig)
