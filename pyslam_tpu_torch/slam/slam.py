"""Slam facade: the main user-facing class (port of
``pyslam_tpu/slam/slam.py:37-229``, ``:336-347``).

``Slam(camera, feature_tracker_config, sensor_type=STEREO, device=...)``
with ``track()``, ``finish()``, ``get_final_trajectory()``, ``timings()``
and ``set_volumetric_integrator()``.  The host drives everything in one
thread: ``track()`` harvests finished back-end work, tracks the frame,
snapshots a new keyframe's images for the volumetric integrator, advances
local mapping by a bounded slice and issues one integrator stage; the
device queue gives the overlap.  The loop detector is not ported yet, and
only the stereo sensor is.
"""

from __future__ import annotations

import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
from pyslam_tpu_torch.features.types import FEATURE_INFO
from pyslam_tpu_torch.io.dataset_types import SensorType
from pyslam_tpu_torch.slam.camera import PinholeCamera
from pyslam_tpu_torch.slam.frame import Frame
from pyslam_tpu_torch.slam.local_mapping import LocalMapping
from pyslam_tpu_torch.slam.map import Map
from pyslam_tpu_torch.slam.tracking import Tracking, TrackingState
from pyslam_tpu_torch.utils.device import same_device
from pyslam_tpu_torch.utils.logging import Printer


class Slam:
    def __init__(self, camera: PinholeCamera,
                 feature_tracker_config: FeatureTrackerConfig | str = "ORB2",
                 loop_detector_config=None, sensor_type: SensorType = SensorType.STEREO, *,
                 device: torch.device | str = "cuda"):
        if loop_detector_config is not None:
            raise NotImplementedError("loop closing is not ported yet")
        if sensor_type != SensorType.STEREO:
            raise NotImplementedError(f"{sensor_type.name} tracking is not ported yet")
        self.camera = camera
        self.sensor_type = sensor_type
        self.device = torch.device(device)
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
        self._last_input = None   # (frame_id, (img, img_right)) of the last call

    def track(self, img, img_right=None, frame_id=0, timestamp=0.0,
              next_input: dict | None = None):
        """Track one stereo frame.  ``next_input`` ({img, img_right,
        frame_id, timestamp} of the NEXT frame) lets its extraction be
        queued right behind this frame's tracking step, so the device works
        on it while the host finishes this frame."""
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
                self.camera, ni["img"], img_right=ni["img_right"],
                timestamp=ni.get("timestamp", 0.0), feature_tracker=self.feature_tracker,
                frame_id=ni["frame_id"]))

        has_next = next_input is not None and next_input.get("img_right") is not None
        if has_next:
            self.tracking.on_fused_dispatched = prefetch
        frame = self.tracking.track(img, img_right=img_right, frame_id=frame_id,
                                    timestamp=timestamp, frame=pre)
        self.tracking.on_fused_dispatched = None
        if has_next and not fired:
            prefetch()
        if self.tracking.reset_requested:
            Printer.yellow("Slam: resetting session (early tracking loss)")
            self.reset()
        # a keyframe created this frame: snapshot its images for the
        # integrator, which takes them when local mapping hands the keyframe
        # over (a keyframe made from the previous call's input takes that)
        vi = self.volumetric_integrator
        kf = self.tracking.kf_ref
        if vi is not None and kf is not None:
            imgs = None
            if kf.id == frame_id:
                imgs = (img, img_right)
            elif self._last_input is not None and kf.id == self._last_input[0]:
                imgs = self._last_input[1]
            if imgs is not None:
                vi.offer_keyframe_data(kf, intensity=imgs[0], img_right=imgs[1])
        self._last_input = (frame_id, (img, img_right))
        self.local_mapping.step_async()
        if vi is not None:
            vi.step()   # at most one integration stage a frame
        return frame

    def finish(self):
        """Drain all queued back-end work, the integrator's last."""
        self.local_mapping.finish()
        if self.volumetric_integrator is not None:
            self.volumetric_integrator.run_all()

    def timings(self) -> dict:
        out = {"tracking": self.tracking.timings.report(),
               "local_mapping": self.local_mapping.timings.report()}
        if self.volumetric_integrator is not None:
            out["volumetric_integrator"] = self.volumetric_integrator.timings.report()
        return out

    def set_volumetric_integrator(self, integrator):
        """Attach a dense integrator: local mapping hands it each finished
        keyframe, and ``track()`` advances it one stage a frame.  It must
        live on this Slam's device."""
        if integrator is not None and not same_device(integrator.device, self.device):
            raise ValueError(f"integrator on {integrator.device}, Slam on {self.device}")
        self.volumetric_integrator = integrator
        self.local_mapping.volumetric_integrator = integrator

    def reset(self):
        self.tracking.reset_requested = False
        self._prefetched = None
        self._last_input = None
        self.map = Map(device=self.device)
        lm = self.local_mapping
        lm.map = self.map
        lm.queue.clear()
        lm._job = lm._tri_job = lm._fuse_job = lm._lba = None
        lm._kf_store = None
        lm.opt_abort_flag = False
        self.tracking.map = self.map
        self.tracking.state = TrackingState.NO_IMAGES_YET
        self.tracking.initializer.reset()
        self.tracking.motion_model.reset()
        if self.volumetric_integrator is not None:
            self.volumetric_integrator.reset()

    def get_final_trajectory(self):
        """(timestamps, Twc poses) re-anchored to the optimised keyframes."""
        self.finish()
        return self.tracking.history.final_trajectory(self.map)
