"""Volumetric integrator: keyframe queue facade and factory (port of
``pyslam_tpu/dense/volumetric_integrator.py``, types TSDF and VOXEL_GRID).

Local mapping hands each finished keyframe over (``add_keyframe``); the
frame loop calls ``step()`` once a frame, and each call issues one bounded
stage on the device: the depth estimate of the next queued keyframe (SGM
on its stereo pair), then one of ``_TSDF_PHASES`` row-interleaved TSDF
updates on each following call.  The schedule is the reference's, so the
CPU, the card and the reference hold the same volume after the same
frames.  With an SGM depth the depth stays on the device from SGM to the
TSDF and is dropped after the last phase; ``rebuild`` re-estimates it.  An
estimator without a device path (a monocular network, or a stereo one
given no right image) gives a host depth, kept with the snapshot, whose
first TSDF phase runs in the same call.  The two semantic types build a
``SemanticTSDFVolume`` (``dense/semantic_volume.py``), which the keyframe
path integrates as a TSDF, as the reference's does: its class scores move
only through ``integrate_semantic``.  GAUSSIAN_SPLATTING builds a
``GaussianSplattingVolume`` (``dense/gaussian_splatting_integrator.py``),
which does a keyframe's whole work at its last phase (a departure from the
reference, whose volume takes no phase; ROADMAP.md section 3).
"""

from __future__ import annotations

import enum
from collections import deque

import numpy as np
import torch

from pyslam_tpu_torch.config_parameters import Parameters
from pyslam_tpu_torch.dense.gaussian_splatting_integrator import GaussianSplattingVolume
from pyslam_tpu_torch.dense.semantic_volume import SemanticTSDFVolume
from pyslam_tpu_torch.dense.tsdf import TSDFVolume
from pyslam_tpu_torch.utils.device import same_device
from pyslam_tpu_torch.utils.logging import Printer
from pyslam_tpu_torch.utils.profiling import StageTimings


class VolumetricIntegratorType(enum.Enum):
    TSDF = "tsdf"
    VOXEL_GRID = "voxel_grid"
    VOXEL_SEMANTIC_GRID = "voxel_semantic_grid"
    VOXEL_SEMANTIC_PROBABILISTIC_GRID = "voxel_semantic_probabilistic_grid"
    GAUSSIAN_SPLATTING = "gaussian_splatting"


class KeyframeSnapshot:
    """Pose, images and depth of a keyframe captured for integration;
    ``depth`` is None while a depth provider has still to estimate it from
    ``intensity`` (and ``img_right``)."""

    def __init__(self, kid, Twc, depth, intensity, img_right=None):
        self.kid = kid
        self.Twc = np.asarray(Twc)
        self.depth = depth
        self.intensity = intensity
        self.img_right = img_right


class VolumetricIntegrator:
    # TSDF insert phases a keyframe: row-interleaved slices of one
    # keyframe's updates, one a frame, so no frame carries a whole insert
    _TSDF_PHASES = 3

    def __init__(self, camera, integrator_type: VolumetricIntegratorType = VolumetricIntegratorType.TSDF,
                 volume: TSDFVolume | None = None, *,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.camera = camera
        self.type = integrator_type
        self.volume = volume or TSDFVolume(device=self.device)
        if not same_device(self.volume.device, self.device):
            raise ValueError(f"volume on {self.volume.device}, integrator on {self.device}")
        self.queue: deque[KeyframeSnapshot] = deque()
        self.snapshots: dict[int, KeyframeSnapshot] = {}
        self._depth_provider = None
        # keyframe images offered by the tracking front-end at keyframe
        # creation (frames keep no full images), keyed by kid, consumed when
        # local mapping hands the keyframe over
        self._pending_data: dict[int, tuple] = {}
        self._staged: tuple | None = None
        self.timings = StageTimings("volumetric_integrator")

    def set_depth_provider(self, estimator):
        if estimator is not None and not same_device(estimator.device, self.device):
            raise ValueError(f"estimator on {estimator.device}, integrator on {self.device}")
        self._depth_provider = estimator

    # ---------------------------------------------------------------- queue
    def offer_keyframe_data(self, kf, intensity=None, img_right=None, depth=None):
        """Register the raw images of a just-created keyframe."""
        self._pending_data[kf.kid] = (intensity, img_right, depth)

    def add_keyframe(self, kf, depth=None, intensity=None, img_right=None):
        if depth is None:
            depth = getattr(kf, "depth_img", None)
        pend = self._pending_data.pop(kf.kid, None)
        if pend is not None:
            p_int, p_right, p_depth = pend
            intensity = intensity if intensity is not None else p_int
            img_right = img_right if img_right is not None else p_right
            depth = depth if depth is not None else p_depth
        if depth is None and not (self._depth_provider is not None and intensity is not None):
            return
        snap = KeyframeSnapshot(kf.kid, kf.Twc, depth, intensity, img_right)
        self.queue.append(snap)
        self.snapshots[kf.kid] = snap

    def step(self) -> bool:
        """Issue one bounded stage: a staged TSDF phase if there is one,
        else the depth estimate (or the first TSDF phase) of the next queued
        keyframe.  Returns False when there was nothing to do."""
        if self._staged is not None:
            snap, depth, phase, est_dev = self._staged
            self._staged = None
            if phase + 1 < self._TSDF_PHASES:
                self._staged = (snap, depth, phase + 1, est_dev)
            self._integrate_depth(snap, depth, estimated_on_device=est_dev, phase=phase,
                                  phases=self._TSDF_PHASES)
            return True
        if not self.queue:
            return False
        self._integrate_snapshot(self.queue.popleft(), split=True)
        return True

    def run_all(self):
        while self.step():
            pass

    def _integrate_snapshot(self, snap: KeyframeSnapshot, split: bool = False):
        estimated_on_device = False
        if snap.depth is None:
            if self._depth_provider is None or snap.intensity is None:
                return
            if snap.img_right is not None and hasattr(self._depth_provider,
                                                      "infer_depth_device"):
                # the depth stays on the device and flows into the TSDF
                with self.timings.stage("sgm"):
                    depth_dev = self._depth_provider.infer_depth_device(
                        snap.intensity, img_right=snap.img_right)
                if split:
                    # the TSDF phases run on the next step() calls
                    self._staged = (snap, depth_dev, 0, True)
                    return
                snap.depth = depth_dev
                estimated_on_device = True
            else:
                # an estimator without a device path (a monocular network):
                # its host depth, non-finite values invalid
                with self.timings.stage("depth"):
                    depth, _ = self._depth_provider.infer(snap.intensity,
                                                          img_right=snap.img_right)
                snap.depth = np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)
        if split and self._TSDF_PHASES > 1:
            # a host depth is phased too: phase 0 now, the rest staged
            self._staged = (snap, snap.depth, 1, estimated_on_device)
            self._integrate_depth(snap, snap.depth, estimated_on_device=estimated_on_device,
                                  phase=0, phases=self._TSDF_PHASES)
            return
        self._integrate_depth(snap, snap.depth, estimated_on_device=estimated_on_device)

    def _integrate_depth(self, snap: KeyframeSnapshot, depth, estimated_on_device: bool = True,
                         phase: int = 0, phases: int = 1):
        if snap.intensity is not None:
            intensity = np.asarray(snap.intensity, np.float32)
            if intensity.ndim == 3:
                intensity = intensity.mean(axis=-1)
        elif isinstance(depth, torch.Tensor):
            intensity = torch.full_like(depth, 128.0)
        else:
            intensity = np.full(np.shape(depth), 128.0, np.float32)
        snap.depth = depth
        with self.timings.stage("tsdf"):
            self.volume.integrate(depth, intensity, snap.Twc, self.camera.K, phase=phase,
                                  phases=phases)
        if estimated_on_device and phase == phases - 1:
            # pin no full-resolution device depth per keyframe for the
            # session; rebuild() re-estimates it
            snap.depth = None

    # -------------------------------------------------------------- rebuild
    def rebuild(self, slam_map):
        """Re-integrate every keyframe with its (corrected) pose."""
        Printer.cyan("volumetric integrator: rebuilding after map correction")
        self.volume.reset()
        for kid in slam_map.keyframe_order:
            snap = self.snapshots.get(kid)
            kf = slam_map.keyframes.get(kid)
            if snap is None or kf is None:
                continue
            snap.Twc = kf.Twc
            self._integrate_snapshot(snap)

    # --------------------------------------------------------------- output
    def get_point_cloud(self):
        return self.volume.extract_point_cloud()

    def save(self, path: str):
        self.volume.save(path)

    def load(self, path: str):
        self.volume.load(path)

    def reset(self):
        self.volume.reset()
        self.queue.clear()
        self.snapshots.clear()
        self._pending_data.clear()
        self._staged = None


def volumetric_integrator_factory(integrator_type=VolumetricIntegratorType.TSDF, camera=None,
                                  environment_type=None, sensor_type=None, *,
                                  device: torch.device | str = "cuda",
                                  **kw) -> VolumetricIntegrator:
    if isinstance(integrator_type, str):
        integrator_type = VolumetricIntegratorType(integrator_type.lower())
    depth_trunc = (Parameters.kVolumetricIntegrationDepthTruncOutdoor
                   if getattr(environment_type, "name", "") == "OUTDOOR"
                   else Parameters.kVolumetricIntegrationDepthTruncIndoor)
    if integrator_type in (VolumetricIntegratorType.VOXEL_SEMANTIC_GRID,
                           VolumetricIntegratorType.VOXEL_SEMANTIC_PROBABILISTIC_GRID):
        vol = SemanticTSDFVolume(depth_trunc=depth_trunc, device=device, **kw)
    elif integrator_type == VolumetricIntegratorType.GAUSSIAN_SPLATTING:
        vol = GaussianSplattingVolume(depth_trunc=depth_trunc, device=device, **kw)
    else:
        vol = TSDFVolume(depth_trunc=depth_trunc, device=device, **kw)
    integ = VolumetricIntegrator(camera, integrator_type, vol, device=device)
    if Parameters.kVolumetricIntegrationUseDepthEstimator:
        # estimate dense depth inside the integrator for sensors without
        # native depth (stereo -> SGM by default, monocular -> the
        # configured network)
        from pyslam_tpu_torch.depth_estimation.depth_estimator import depth_estimator_factory

        est_type = Parameters.kVolumetricIntegrationDepthEstimatorType
        kw_extra = {}
        if str(est_type).lower() in ("sgbm", "raft_stereo", "crestereo", "crestereo_megengine"):
            kw_extra["downscale"] = Parameters.kVolumetricIntegrationDepthSGMDownscale
        integ.set_depth_provider(depth_estimator_factory(est_type, camera=camera, device=device,
                                                         **kw_extra))
    return integ
