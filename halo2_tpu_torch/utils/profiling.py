"""Phase timers and counters for the prover, and the measures of a kernel.

`PhaseTimes` records the seconds between successive marks; on a CUDA
device it waits for the device at every mark, so a phase is charged the
work it enqueued.  `counters` is a small registry (MSM / NTT call counts).
`time_cuda`, `time_graph`, `bound_ms` and `max_abs_err` are what
chip_smoke.py and the examples report for a kernel: its time on the card
(launched from Python, and replayed from a CUDA graph with no host in the
way), the least time the card could take for the same work, and its error
against a plain version.
"""

from __future__ import annotations

import functools
import subprocess
import time

import torch

counters: dict = {}

# Peaks of one H100 SXM at its full power limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# The data sheet gives no 32-bit integer rate.  The kernels' integer work is
# counted in multiply-add-class instructions (a CIOS Montgomery product is
# 264 of them, see fields/cuda_ops.py), issued at 64 a clock on each SM:
# `int_mad_per_s` takes the SM count and the SM clock the card reports.
INT_MAD_PER_CLOCK_PER_SM = 64


@functools.lru_cache(maxsize=None)
def card_int_rate(index: int = 0) -> dict:
    """The integer rate of CUDA card `index`: 64 multiply-adds a clock on
    each SM (the count torch reports) at the maximum SM clock nvidia-smi
    reports.  {"sms", "sm_clock_mhz", "mad_per_s"}."""
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return {"sms": sms, "sm_clock_mhz": mhz,
            "mad_per_s": INT_MAD_PER_CLOCK_PER_SM * sms * mhz * 1e6}


def incr(name: str, v: float = 1):
    counters[name] = counters.get(name, 0) + v


def reset():
    counters.clear()


class PhaseTimes:
    """pm = PhaseTimes(device); ...; pm("phase") records the seconds since
    the previous mark under that name (summed if the name repeats).  With
    peaks=True on a CUDA device it also records, under `peaks`, the peak
    allocated and reserved bytes since the previous mark (the device's
    peak statistics are reset at every mark)."""

    def __init__(self, device, peaks: bool = False):
        self.device = torch.device(device)
        self.seconds: dict = {}
        self.peaks: dict = {}
        self._peaks = peaks and self.device.type == "cuda"
        self._t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            if self._peaks:
                torch.cuda.reset_peak_memory_stats(self.device)
        return time.perf_counter()

    def __call__(self, name: str):
        if self._peaks:
            torch.cuda.synchronize(self.device)
            got = {"allocated": torch.cuda.max_memory_allocated(self.device),
                   "reserved": torch.cuda.max_memory_reserved(self.device)}
            was = self.peaks.get(name, got)
            self.peaks[name] = {key: max(got[key], was[key]) for key in got}
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


def time_graph(fn, reps: int = 20, replays: int = 3) -> float:
    """Milliseconds per call of fn with no host in the way: `reps` calls
    captured once in a CUDA graph (after one warm call), the graph replayed
    once to warm up, then `replays` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def timed(fn):
    """(fn(), milliseconds) of one call between CUDA events, for work too
    slow to repeat (a plain version at full width)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float | None = None):
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the operations over their peak rate (by
    default integer multiply-add-class instructions at `card_int_rate`);
    and which of the two it is ("bytes" or "operations")."""
    if ops_per_s is None:
        ops_per_s = card_int_rate()["mad_per_s"]
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
