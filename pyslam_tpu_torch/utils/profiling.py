"""Per-stage timing: named moving-average stage timers.

Copied from ``pyslam_tpu/utils/profiling.py`` (``StageTimings`` only; the
device dispatch/readback counters and the JAX trace helpers are not ported).
"""

from __future__ import annotations

import contextlib

from pyslam_tpu_torch.utils.timer import TimerFps


class StageTimings:
    """Named moving-average stage timers with one-line reporting.

    >>> t = StageTimings("tracking")
    >>> with t.stage("pose_opt"):
    ...     ...
    >>> t.report()   # {'pose_opt': {'last_ms': ..., 'avg_ms': ..., 'fps': ...}}
    """

    def __init__(self, name: str = "", window: int = 30):
        self.name = name
        self.timers: dict[str, TimerFps] = {}

    @contextlib.contextmanager
    def stage(self, stage_name: str):
        t = self.timers.get(stage_name)
        if t is None:
            t = self.timers[stage_name] = TimerFps(stage_name)
        t.start()
        try:
            yield t
        finally:
            t.refresh()

    def add_sample(self, stage_name: str, seconds: float):
        t = self.timers.get(stage_name)
        if t is None:
            t = self.timers[stage_name] = TimerFps(stage_name)
        t.elapsed = seconds
        t.moving_average.add(seconds)

    def report(self) -> dict:
        return {
            k: {
                "last_ms": 1000.0 * t.elapsed,
                "avg_ms": 1000.0 * t.moving_average.average(),
                "fps": t.fps,
                "calls": t.calls,
                "total_ms": 1000.0 * t.total,
            }
            for k, t in self.timers.items()
        }

    def summary(self) -> str:
        # avg over ALL calls x count: the attribution that matters when a
        # stage runs on only some frames (windowed averages hide counts)
        parts = [
            f"{k}={v['total_ms'] / max(v['calls'], 1):.1f}ms*{v['calls']}"
            for k, v in sorted(self.report().items())
        ]
        prefix = f"[{self.name}] " if self.name else ""
        return prefix + " ".join(parts)
