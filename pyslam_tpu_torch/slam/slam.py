"""Slam facade: the main user-facing class (port of
``pyslam_tpu/slam/slam.py``).

``Slam(camera, feature_tracker_config, sensor_type=STEREO | RGBD |
MONOCULAR, device=...)`` with ``track()``, ``finish()``,
``get_final_trajectory()``, ``get_keyframe_trajectory()``,
``bundle_adjust()``, ``timings()``, ``timings_summary()``,
``set_volumetric_integrator()``, ``set_semantic_mapping()``, ``reset()``
and the system state's
``save_system_state()`` / ``load_system_state()`` (``map.json`` in the
native or the reference's schema, ``config_info.json``, the loop-closing
DB and the volumetric state).  A loaded map lives on the session's
device, and the session relocalises in it (``INIT_RELOCALIZE``).  The host
drives everything in one thread: ``track()`` harvests finished back-end
work, tracks the frame, snapshots a new keyframe's images (and an RGBD
keyframe's sensor depth, so the integrator takes it instead of estimating
one) for the volumetric integrator and the semantic mapper, advances local
mapping by a bounded slice, services loop closing (one keyframe's
detection, or a poll of the asynchronous GBA), issues one integrator stage
and segments at most one keyframe; the device queue gives the overlap.

``depth_estimator=`` upgrades a MONOCULAR session to RGBD, as the
reference does: ``track()`` estimates the frame's depth
(``depth_estimator.infer(img, img_right=img_right)``) before tracking and
hands it on as a sensor depth, to the frame and to the integrator's
keyframe snapshot.  As in the reference, a right image given to ``track()``
also reaches the frame, whose keypoint depths then come from the stereo
match; without one they come from the estimated depth.  The next frame is
prefetched only when it needs no estimate of its own (it has a right image
or a depth), as the reference prefetches only stereo frames.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
from pyslam_tpu_torch.features.types import FEATURE_INFO
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.loop_closing.loop_closing import LoopClosing
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.frame import Frame
from pyslam_tpu_torch.slam.global_bundle_adjustment import global_bundle_adjustment
from pyslam_tpu_torch.slam.local_mapping import LocalMapping
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.slam.map_serialization import map_from_json, map_to_json
from pyslam_tpu_torch.slam.map_serialization_ref import (
    is_reference_schema,
    map_from_reference_json,
    map_to_reference_json,
)
from pyslam_tpu_torch.slam.tracking import Tracking, TrackingState
from pyslam_tpu_torch.utils.device import same_device
from pyslam_tpu_torch.utils.logging import Printer


class Slam:
    def __init__(self, camera: PinholeCamera,
                 feature_tracker_config: FeatureTrackerConfig | str = "ORB2",
                 loop_detector_config=None, sensor_type: SensorType = SensorType.STEREO, *,
                 depth_estimator=None, device: torch.device | str = "cuda"):
        self.camera = camera
        self.device = torch.device(device)
        self.depth_estimator = depth_estimator
        if depth_estimator is not None:
            if not same_device(depth_estimator.device, self.device):
                raise ValueError(f"depth estimator on {depth_estimator.device}, "
                                 f"Slam on {self.device}")
            if sensor_type == SensorType.MONOCULAR:
                Printer.yellow("Slam: depth estimator attached - upgrading MONOCULAR to RGBD")
                sensor_type = SensorType.RGBD
        self.sensor_type = sensor_type
        self.feature_tracker_config = (feature_tracker_config
                                       if isinstance(feature_tracker_config, FeatureTrackerConfig)
                                       else None)
        self.feature_tracker = feature_tracker_factory(feature_tracker_config,
                                                       device=self.device)
        # session descriptor gates from the descriptor's acceptance distance
        info = FEATURE_INFO.get(self.feature_tracker.config.descriptor_type)
        if info is not None:
            Parameters.kMaxDescriptorDistance = float(info.max_distance)
            Parameters.kMaxOrbDistanceSearchByReproj = 0.5 * float(info.max_distance)
        self.map = Map(device=self.device)
        self.local_mapping = LocalMapping(self.map, camera, sensor_type, self.feature_tracker)
        self.tracking = Tracking(camera, self.feature_tracker, self.map, sensor_type,
                                 self.local_mapping)
        self._prefetched = None   # (frame_id, Frame) built during the last call
        self.volumetric_integrator = None
        self.semantic_mapping = None   # attached by set_semantic_mapping()
        self._last_input = None   # (frame_id, (img, img_right, depth)) of the last call
        self.loop_closing = None
        self.GBA = None
        if loop_detector_config is not None and Parameters.kUseLoopClosing:
            self.loop_closing = LoopClosing(self.map, camera, self.feature_tracker,
                                            loop_detector_config, sensor_type=sensor_type,
                                            device=self.device)
            self.local_mapping.loop_closing = self.loop_closing
            self.loop_closing.local_mapping = self.local_mapping
            self.tracking.relocalizer = self.loop_closing.relocalizer
            self.GBA = self.loop_closing.gba   # the asynchronous post-loop GBA

    def track(self, img, img_right=None, depth=None, frame_id=0, timestamp=0.0,
              next_input: dict | None = None):
        """Track one frame: a stereo pair, an image with its metric depth
        map (RGBD), or one image (monocular).  ``next_input`` ({img,
        img_right, depth, frame_id, timestamp} of the NEXT frame) lets its
        extraction be queued right behind this frame's tracking step, so the
        device works on it while the host finishes this frame.  With a depth
        estimator and no ``depth``, the frame's depth is estimated first."""
        if depth is None and self.depth_estimator is not None:
            with self.tracking.timings.stage("depth_estimate"):
                depth, _ = self.depth_estimator.infer(img, img_right=img_right)
        self.local_mapping.harvest()
        pre = None
        if self._prefetched is not None:
            pf_id, pf_frame = self._prefetched
            self._prefetched = None
            if pf_id == frame_id:
                pre = pf_frame
        fired = []

        def prefetch():
            fired.append(True)
            ni = next_input
            self._prefetched = (ni["frame_id"], Frame(
                self.camera, ni["img"], img_right=ni.get("img_right"), depth=ni.get("depth"),
                timestamp=ni.get("timestamp", 0.0), feature_tracker=self.feature_tracker,
                frame_id=ni["frame_id"]))

        has_next = next_input is not None and next_input.get("img") is not None and (
            self.depth_estimator is None or next_input.get("img_right") is not None
            or next_input.get("depth") is not None)
        if has_next:
            self.tracking.on_fused_dispatched = prefetch
        frame = self.tracking.track(img, img_right=img_right, depth=depth, frame_id=frame_id,
                                    timestamp=timestamp, frame=pre)
        self.tracking.on_fused_dispatched = None
        if has_next and not fired:
            prefetch()
        if self.tracking.reset_requested:
            Printer.yellow("Slam: resetting session (early tracking loss)")
            self.reset()
        # a keyframe created this frame: snapshot its images (and sensor
        # depth) for the integrator and the semantic mapper, which take them
        # when local mapping hands the keyframe over (a keyframe made from
        # the previous call's input takes that)
        vi, sm = self.volumetric_integrator, self.semantic_mapping
        kf = self.tracking.kf_ref
        if kf is not None and (vi is not None or sm is not None):
            imgs = None
            if kf.id == frame_id:
                imgs = (img, img_right, depth)
            elif self._last_input is not None and kf.id == self._last_input[0]:
                imgs = self._last_input[1]
            if imgs is not None:
                l_img, l_right, l_depth = imgs
                if vi is not None:
                    vi.offer_keyframe_data(
                        kf, intensity=l_img, img_right=l_right,
                        depth=None if l_depth is None
                        else np.where(np.asarray(l_depth) > 0, l_depth, 0.0))
                if sm is not None:
                    sm.offer_keyframe_image(kf.kid, l_img)
        self._last_input = (frame_id, (img, img_right, depth))
        self.local_mapping.step_async()
        if self.loop_closing is not None:
            self.loop_closing.step()
        if vi is not None:
            vi.step()   # at most one integration stage a frame
        if sm is not None:
            sm.step()   # at most one segmentation a frame
        return frame

    def finish(self):
        """Drain all queued back-end work, the integrator's last."""
        self.local_mapping.finish()
        if self.loop_closing is not None:
            self.loop_closing.finish()
        if self.volumetric_integrator is not None:
            self.volumetric_integrator.run_all()
        if self.semantic_mapping is not None:
            self.semantic_mapping.run_all()

    @property
    def state(self) -> TrackingState:
        return self.tracking.state

    def timings(self) -> dict:
        out = {"tracking": self.tracking.timings.report(),
               "local_mapping": self.local_mapping.timings.report()}
        if self.loop_closing is not None:
            out["loop_closing"] = self.loop_closing.timings.report()
            out["gba"] = self.loop_closing.gba.timings.report()
        if self.volumetric_integrator is not None:
            out["volumetric_integrator"] = self.volumetric_integrator.timings.report()
        return out

    def timings_summary(self) -> str:
        """One line a module: each stage's mean over all its calls times its
        call count (a windowed mean hides how often a stage ran)."""
        return "\n".join(
            f"[{mod}] " + " ".join(
                f"{k}={v['total_ms'] / max(v['calls'], 1):.1f}ms*{v['calls']}"
                for k, v in sorted(st.items()))
            for mod, st in self.timings().items() if st)

    def set_volumetric_integrator(self, integrator):
        """Attach a dense integrator: local mapping hands it each finished
        keyframe, and ``track()`` advances it one stage a frame.  It must
        live on this Slam's device."""
        if integrator is not None and not same_device(integrator.device, self.device):
            raise ValueError(f"integrator on {integrator.device}, Slam on {self.device}")
        self.volumetric_integrator = integrator
        self.local_mapping.volumetric_integrator = integrator

    def set_semantic_mapping(self, semantic_mapping):
        """Attach a semantic mapper: local mapping hands it each digested
        keyframe and, with ``kUseSemanticsInOptimization``, weights its BA
        by the keypoints' classes; ``track()`` segments one keyframe a
        frame.  A segmenter with a network must live on this Slam's device
        (the weight-free one runs on the host)."""
        seg_dev = getattr(getattr(semantic_mapping, "segmenter", None), "device", None)
        if seg_dev is not None and not same_device(seg_dev, self.device):
            raise ValueError(f"segmenter on {seg_dev}, Slam on {self.device}")
        self.semantic_mapping = semantic_mapping
        self.local_mapping.semantic_mapping = semantic_mapping

    def _adopt_map(self, new_map: Map):
        """Point every module at ``new_map`` and drop the work queued for
        the old one: the prefetched frame, local mapping's queue, jobs and
        keyframe device store."""
        self._prefetched = None
        self._last_input = None
        self.map = new_map
        lm = self.local_mapping
        lm.map = new_map
        lm.queue.clear()
        lm._job = lm._tri_job = lm._fuse_job = lm._lba = None
        lm._kf_store = None
        lm.opt_abort_flag = False
        self.tracking.map = new_map
        if self.loop_closing is not None:
            self.loop_closing.map = new_map
        if self.semantic_mapping is not None:
            self.semantic_mapping.reset(new_map)

    def reset(self):
        self.tracking.reset_requested = False
        self._adopt_map(Map(device=self.device))
        self.tracking.state = TrackingState.NO_IMAGES_YET
        self.tracking.initializer.reset()
        self.tracking.motion_model.reset()
        if self.loop_closing is not None:
            self.loop_closing.reset()
        if self.volumetric_integrator is not None:
            self.volumetric_integrator.reset()

    def get_final_trajectory(self):
        """(timestamps, Twc poses) re-anchored to the optimised keyframes."""
        self.finish()
        return self.tracking.history.final_trajectory(self.map)

    def get_keyframe_trajectory(self):
        """(timestamps, Twc poses) of the keyframes, in insertion order."""
        ts, poses = [], []
        for kid in self.map.keyframe_order:
            kf = self.map.keyframes[kid]
            ts.append(kf.timestamp)
            poses.append(kf.Twc)
        return np.asarray(ts), np.asarray(poses)

    def bundle_adjust(self, iters: int = 15) -> float:
        """Full-map global BA on the session's device; returns its cost."""
        self.finish()
        return global_bundle_adjustment(self.map, self.camera, self.feature_tracker,
                                        iters=iters, device=self.device)

    # ------------------------------------------------------- state save/load
    def save_system_state(self, path: str, schema: str = "native"):
        """Write the system state to the folder ``path``: ``map.json``
        (``schema="native"``: the compact b64 schema; ``"reference"``: the
        reference's cross-core schema), ``config_info.json``, the
        loop-closing DB and ``volumetric_state.npz`` (the JAX package's
        layout: either package loads the other's)."""
        self.finish()
        os.makedirs(path, exist_ok=True)
        if schema == "reference":
            d = map_to_reference_json(self.map, self.camera, sensor_type=self.sensor_type,
                                      feature_tracker_config=self.feature_tracker_config)
        elif schema == "native":
            d = map_to_json(self.map)
            d["camera"] = self.camera.to_json()
            d["sensor_type"] = self.sensor_type.name
            if self.feature_tracker_config is not None:
                d["feature_tracker_config"] = self.feature_tracker_config.to_json()
        else:
            raise ValueError(f"unknown map schema {schema!r}")
        with open(os.path.join(path, "map.json"), "w") as f:
            json.dump(d, f)
        with open(os.path.join(path, "config_info.json"), "w") as f:
            json.dump({"sensor_type": self.sensor_type.name,
                       "num_keyframes": self.map.num_keyframes(),
                       "num_points": self.map.num_points()}, f, indent=2)
        if self.loop_closing is not None:
            self.loop_closing.save(path)
        if self.volumetric_integrator is not None:
            self.volumetric_integrator.save(os.path.join(path, "volumetric_state.npz"))
        Printer.green(f"saved system state to {path}")

    def load_system_state(self, path: str):
        """Replace the session's map by the one saved in ``path`` (either
        schema, either package), with its loop-closing DB and volumetric
        state where saved; the session then relocalises in it
        (``INIT_RELOCALIZE``, the reference keyframe the map's last)."""
        with open(os.path.join(path, "map.json")) as f:
            d = json.load(f)
        if d.get("format", "").startswith("pyslam_tpu_map"):
            new_map = map_from_json(d, self.feature_tracker, self.camera)
        elif is_reference_schema(d):
            new_map = map_from_reference_json(d, self.feature_tracker, self.camera)
        else:
            raise ValueError(f"unrecognized map.json schema in {path}")
        self._adopt_map(new_map)
        if self.loop_closing is not None:
            if self.loop_closing.load(path):
                Printer.green("loop-closing DB restored from saved state")
            else:
                # a save without the DB: keyframes are described again as
                # they are revisited
                self.loop_closing.reset()
        vi = self.volumetric_integrator
        vol_path = os.path.join(path, "volumetric_state.npz")
        if vi is not None and os.path.exists(vol_path):
            vi.load(vol_path)
        self.tracking.state = TrackingState.INIT_RELOCALIZE
        self.tracking.kf_ref = self.map.last_keyframe()
        self._check_devices()
        Printer.green(f"loaded system state from {path}: {self.map.num_keyframes()} KFs, "
                      f"{self.map.num_points()} points")

    def _check_devices(self):
        """Refuse a loaded state that left a part off the session's device."""
        parts = [("map", self.map.device)]
        parts += [(f"keyframe {kid}", kf.device) for kid, kf in self.map.keyframes.items()]
        if self.loop_closing is not None:
            parts.append(("vocabulary", self.loop_closing.detector.vocabulary.device))
        if self.volumetric_integrator is not None:
            parts.append(("volume", self.volumetric_integrator.volume.device))
        bad = [(name, str(dev)) for name, dev in parts if not same_device(dev, self.device)]
        if bad:
            raise RuntimeError(f"loaded state off the session's device {self.device}: {bad[:5]}")
