"""Phase timers and counters for the prover, and the measures of a kernel.

`PhaseTimes` records the seconds between successive marks; on a CUDA
device it waits for the device at every mark, so a phase is charged the
work it enqueued.  `counters` is a small registry (MSM / NTT call counts).
`time_cuda`, `bound_ms` and `max_abs_err` are what chip_smoke.py and the
examples report for a kernel: its time on the card, the least time the
card could take for the same work, and its error against a plain version.
"""

from __future__ import annotations

import time

import torch

counters: dict = {}

# Peaks of one H100 SXM at its full power limit (NVIDIA's data sheet).  The
# data sheet gives no 32-bit integer rate: an SM runs half as many 32-bit
# integer multiply-adds a clock as float32 ones, so the integer peak is
# taken as half the float32 peak, a multiply-add counted as two operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
BF16_FLOP_PER_S = 989e12


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


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call of fn, by CUDA events around `reps` calls
    after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = INT32_OPS_PER_S):
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the operations over their peak rate; and
    which of the two it is ("bytes" or "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def max_abs_err(got, want) -> int:
    """Largest absolute difference of two integer tensors (or of the pairs
    of two sequences of them), which must have equal shapes."""
    if not isinstance(got, (tuple, list)):
        got, want = [got], [want]
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max().item()))
    return err
