"""Fault tolerance: preemption hook and straggler watchdog.

* ``PreemptionGuard`` — SIGTERM/SIGINT flips a flag; the train loop
  checkpoints and exits cleanly at the next step boundary (tested by
  setting the flag directly).
* ``StepWatchdog`` — flags steps slower than ``factor`` x the trailing
  median: persistent outliers get reported for replacement.

The reference's ``reshard`` (a state placed onto a new device mesh with
its parameters' shardings) waits for the LM side's sharding
(``distributed/sharding.param_shardings``, ROADMAP queue 1 item 17).
"""
from __future__ import annotations

import signal
import time


class PreemptionGuard:
    def __init__(self, install_handlers: bool = False):
        self.preempted = False
        if install_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self.preempted = True

    def trigger(self):  # tests / external pod-manager hook
        self.preempted = True


class StepWatchdog:
    """Flags steps slower than ``factor`` x trailing-median (stragglers)."""

    def __init__(self, factor: float = 2.0, window: int = 16):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged: list[int] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        hist = self.times[-self.window:]
        slow = bool(hist) and dt > self.factor * sorted(hist)[len(hist) // 2]
        self.times.append(dt)
        if slow:
            self.flagged.append(step)
        return slow
