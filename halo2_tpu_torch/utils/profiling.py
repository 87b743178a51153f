"""Phase timers and counters for the prover.

`PhaseTimes` records the seconds between successive marks; on a CUDA
device it waits for the device at every mark, so a phase is charged the
work it enqueued.  `counters` is a small registry (MSM / NTT call counts).
"""

from __future__ import annotations

import time

import torch

counters: dict = {}


def incr(name: str, v: float = 1):
    counters[name] = counters.get(name, 0) + v


def reset():
    counters.clear()


class PhaseTimes:
    """pm = PhaseTimes(device); ...; pm("phase") records the seconds since
    the previous mark under that name (summed if the name repeats)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict = {}
        self._t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, name: str):
        now = self._now()
        self.seconds[name] = self.seconds.get(name, 0.0) + (now - self._t)
        self._t = now


def phase_marker(device, phases: PhaseTimes | None = None):
    """The caller's PhaseTimes, or a do-nothing marker when none is given."""
    if phases is not None:
        phases._t = phases._now()
        return phases
    return lambda name: None
