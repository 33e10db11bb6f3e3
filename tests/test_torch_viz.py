"""The port's viewers (pyslam_tpu_torch/viz/{html_viewer,live_viewer,
viewer3d}.py), ``main_slam --viewer`` and ``main_map_viewer`` on the CPU.

- ``build_map_snapshot`` and the exported HTML are identical in both
  packages for the same map: a port session's map written with the port's
  map schema and read back by each package's ``map_from_json`` (no JAX
  session runs), with the same trajectory.
- The live viewer's HTTP protocol, as tests/test_live_viewer.py tests the
  JAX package's: the page and the version-gated ``/state.json``, the
  throttle, pause / step / resume, the one-shot requests, quit, and an
  unknown command.
- ``Viewer3D``'s graph layers, matplotlib snapshot and plot drawer, as
  tests/test_viz.py tests the JAX package's.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (caps torch threads per test worker)
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.io.synthetic import SyntheticDataset
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.slam import Slam
from pyslam_tpu_torch.viz.live_viewer import LiveViewer3D


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """An 8-frame RGBD session of the port and its saved state."""
    ds = SyntheticDataset(num_frames=8, sensor_type=SensorType.RGBD, trajectory="line",
                          step=0.3)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=20.0)
    slam = Slam(cam, FeatureTrackerConfig(num_features=300, num_levels=4),
                sensor_type=SensorType.RGBD, device="cpu")
    for i in range(len(ds)):
        slam.track(ds.getImage(i), depth=ds.getDepth(i), frame_id=i,
                   timestamp=ds.getTimestamp(i))
    slam.finish()
    assert slam.map.num_keyframes() >= 2
    state = str(tmp_path_factory.mktemp("state"))
    slam.save_system_state(state)
    return slam, state


class _Loaded:
    """A map read back from a saved state, with the session's trajectory:
    what ``build_map_snapshot`` reads of a ``Slam``."""

    def __init__(self, m, trajectory):
        self.map = m
        self._trajectory = trajectory

    def get_final_trajectory(self):
        return self._trajectory


def _loaded_maps(session):
    from pyslam_tpu.features.tracker import FeatureTrackerConfig as JaxTrackerConfig
    from pyslam_tpu.features.tracker import feature_tracker_factory as jax_tracker
    from pyslam_tpu.slam.map_serialization import map_from_json as jax_map_from_json
    from pyslam_tpu_torch.slam.map_serialization import map_from_json

    slam, state = session
    with open(os.path.join(state, "map.json")) as f:
        d = json.load(f)
    traj = slam.get_final_trajectory()
    jt = jax_tracker(JaxTrackerConfig(num_features=300, num_levels=4))
    return (_Loaded(jax_map_from_json(d, jt, slam.camera), traj),
            _Loaded(map_from_json(d, slam.feature_tracker, slam.camera), traj))


def test_snapshot_and_html_identical_in_both_packages(session, tmp_path):
    from pyslam_tpu.viz import html_viewer as jax_html
    from pyslam_tpu_torch.viz import html_viewer

    ref, got = _loaded_maps(session)
    dense = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    want = jax_html.build_map_snapshot(ref, dense_points=dense, covis_min_weight=1)
    snap = html_viewer.build_map_snapshot(got, dense_points=dense, covis_min_weight=1)
    assert json.dumps(snap) == json.dumps(want)
    assert snap["n_kfs"] == session[0].map.num_keyframes() and snap["span"]
    a = html_viewer.export_html_map(got, str(tmp_path / "port.html"), dense_points=dense)
    b = jax_html.export_html_map(ref, str(tmp_path / "jax.html"), dense_points=dense)
    assert open(a, "rb").read() == open(b, "rb").read()


# ------------------------------------------------------ the live viewer
@pytest.fixture()
def viewer():
    v = LiveViewer3D(port=0)   # an ephemeral port
    yield v
    v.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        return json.loads(r.read())


def test_serves_page_and_versioned_state(viewer, session):
    slam = session[0]
    status, body = _get(viewer.url + "/")
    assert status == 200 and b"pyslam_tpu live" in body
    st = json.loads(_get(viewer.url + "/state.json?v=-1")[1])
    assert st["scene"] is None and st["version"] == 0
    viewer.update(slam, status="frame 7", force=True)
    st = json.loads(_get(viewer.url + "/state.json?v=-1")[1])
    assert st["version"] == 1 and st["status"] == "frame 7"
    scene = st["scene"]
    assert scene["n_kfs"] >= 2 and len(scene["traj"]) >= 7
    assert len(scene["kf_poses"][0]) == 12          # 3x4 row-major
    # version-gated: the same version leaves the scene out
    st2 = json.loads(_get(viewer.url + f"/state.json?v={st['version']}")[1])
    assert st2["scene"] is None and st2["version"] == st["version"]


def test_update_throttling(viewer, session):
    viewer.update(session[0], force=True)
    v0 = viewer._version
    viewer.update(session[0])            # within the minimum interval: no-op
    assert viewer._version == v0
    viewer.update(session[0], force=True)
    assert viewer._version == v0 + 1


def test_pause_step_resume_protocol(viewer):
    assert not viewer.is_paused()
    assert _post(viewer.url + "/control", {"cmd": "pause"})["ok"]
    assert viewer.is_paused()
    released = []

    def loop_iter():
        viewer.wait_if_paused(poll=0.01)
        released.append(time.monotonic())

    t = threading.Thread(target=loop_iter)
    t.start()
    time.sleep(0.15)
    assert not released, "the loop must block while paused"
    _post(viewer.url + "/control", {"cmd": "step"})
    t.join(timeout=3.0)
    assert released and viewer.is_paused()
    _post(viewer.url + "/control", {"cmd": "resume"})
    assert not viewer.is_paused()
    viewer.wait_if_paused()                  # returns at once now


def test_one_shot_requests_drain_once(viewer):
    for c in ("save", "gba", "reset", "save"):   # a duplicate save coalesces
        _post(viewer.url + "/control", {"cmd": c})
    assert viewer.take_requests() == ["save", "gba", "reset"]
    assert viewer.take_requests() == []


def test_quit_releases_paused_loop(viewer):
    _post(viewer.url + "/control", {"cmd": "pause"})
    done = threading.Event()

    def loop_iter():
        viewer.wait_if_paused(poll=0.01)
        done.set()

    threading.Thread(target=loop_iter).start()
    _post(viewer.url + "/control", {"cmd": "quit"})
    assert done.wait(timeout=3.0)
    assert viewer.should_quit()


def test_unknown_command_rejected(viewer):
    assert not _post(viewer.url + "/control", {"cmd": "nonsense"})["ok"]
    assert _get(viewer.url + "/state.json?v=-1")[0] == 200


# ------------------------------------------------- Viewer3D and the entries
def test_graph_edges(session):
    from pyslam_tpu_torch.viz.viewer3d import Viewer3D

    cov, span, _ = Viewer3D._graph_edges(session[0], covis_min_weight=1)
    assert len(span) >= 1 and len(cov) >= 1
    for p, q in span:
        assert p.shape == (3,) and q.shape == (3,)


def test_matplotlib_snapshot_and_plot_drawer(session, tmp_path):
    from pyslam_tpu_torch.viz.viewer3d import SlamPlotDrawer, Viewer3D

    out = str(tmp_path / "m.png")
    Viewer3D(backend="matplotlib", out_path=out).draw_map(session[0])
    assert os.path.getsize(out) > 1000
    d = SlamPlotDrawer(out_path=str(tmp_path / "plots.png"))
    for i in range(5):
        d.add(i, 100 + i, 80 + i, fps=10.0, timings=session[0].timings())
    d.save()
    assert os.path.getsize(d.out_path) > 1000
    assert any(k.startswith("tracking.") for k in d.timing_curves)


def test_main_map_viewer_runs(session, tmp_path):
    from pyslam_tpu_torch import main_map_viewer

    png, html = str(tmp_path / "view.png"), str(tmp_path / "view.html")
    assert main_map_viewer.main([session[1], "--out", png, "--html", html,
                                 "--device", "cpu"]) == 0
    assert os.path.getsize(png) > 1000 and "frustumSegs" in open(html).read()


def test_main_slam_viewer_serves_the_session(monkeypatch):
    """``main_slam --viewer`` publishes every frame and closes its server
    at the end (a run without a terminal does not wait for quit)."""
    from pyslam_tpu_torch import main_slam
    from pyslam_tpu_torch.viz import live_viewer

    seen = []

    class Recording(live_viewer.LiveViewer3D):
        def update(self, slam, status=None, dense_points=None, force=False):
            seen.append(status)
            super().update(slam, status=status, dense_points=dense_points, force=force)

        def close(self):
            seen.append("closed")
            super().close()

    monkeypatch.setattr(live_viewer, "LiveViewer3D", Recording)
    assert main_slam.main(["--viewer", "--viewer_port", "0", "--sensor", "rgbd",
                           "--frames", "3", "--device", "cpu"]) == 0
    assert [s.split(" ")[1] for s in seen[:3]] == ["0/3", "1/3", "2/3"]
    assert seen[-1] == "closed"
