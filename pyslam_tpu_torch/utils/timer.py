"""Timing utilities (reference: pySLAM ``pyslam/utilities/timer.py``
``Timer``/``TimerFps``): per-stage moving-average timers surfaced by the
tracking/mapping modules and the plot drawer.

Host-only module, copied from ``pyslam_tpu/utils/timer.py`` (the machine with the
card has no JAX, so the port cannot import the reference).
"""

from __future__ import annotations

import time


class MovingAverage:
    def __init__(self, window: int = 30):
        self.window = window
        self.values: list[float] = []

    def add(self, v: float):
        self.values.append(v)
        if len(self.values) > self.window:
            self.values.pop(0)

    def average(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0


class Timer:
    def __init__(self, name: str = "", is_verbose: bool = False):
        self.name = name
        self.is_verbose = is_verbose
        self._start = time.perf_counter()
        self.elapsed = 0.0

    def start(self):
        self._start = time.perf_counter()
        return self

    def refresh(self) -> float:
        self.elapsed = time.perf_counter() - self._start
        if self.is_verbose:
            print(f"[Timer] {self.name}: {self.elapsed*1000:.2f} ms")
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.refresh()


class TimerFps(Timer):
    def __init__(self, name: str = "", average_width: int = 10, is_verbose: bool = False):
        super().__init__(name, is_verbose)
        self.moving_average = MovingAverage(average_width)
        self.calls = 0         # total refreshes (attribution: avg * calls)
        self.total = 0.0       # total seconds across ALL calls (not windowed)

    def refresh(self) -> float:
        e = super().refresh()
        self.moving_average.add(e)
        self.calls += 1
        self.total += e
        return e

    @property
    def fps(self) -> float:
        avg = self.moving_average.average()
        return 1.0 / avg if avg > 0 else 0.0
