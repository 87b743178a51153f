"""Phase timers, the span profiler and counters for the prover, and the
measures of a kernel.

`PhaseTimes` records the seconds between successive marks; on a CUDA
device it waits for the device at every mark, so a phase is charged the
work it enqueued.  `counters` is a small registry (MSM / NTT call counts).

The span profiler is the JAX package's (halo2_tpu/utils/profiling.py, the
reference's `profile` feature): `span(name)` scopes and `phase_marker`'s
marks, when HALO2_TPU_PROFILE=1 (or `enable()`), print one stderr line
each and accumulate into a tree that `report()` prints with totals, counts
and shares.  With HALO2_TPU_PROFILE_SYNC=1 (or `enable(sync=True)`) every
span exit and mark first waits for the card (`torch.cuda.synchronize`),
so a scope is charged its device time, not its enqueue time; that
serialises the host with the card, so it is for attribution, not for
end-to-end times.

`time_cuda`, `time_graph`, `bound_ms` and `max_abs_err` are what
chip_smoke.py and the examples report for a kernel: its time on the card
(launched from Python, and replayed from a CUDA graph with no host in the
way), the least time the card could take for the same work, and its error
against a plain version.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import torch

counters: dict = {}

_enabled = os.environ.get("HALO2_TPU_PROFILE", "") == "1"
_sync = os.environ.get("HALO2_TPU_PROFILE_SYNC", "") == "1"


class _Node:
    __slots__ = ("name", "total", "count", "children")

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children: dict[str, _Node] = {}

    def child(self, name):
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = _Node(name)
        return node


_root = _Node("total")
_stack = [_root]


def enable(on: bool = True, sync: bool | None = None):
    """Turn the span profiler on or off (and its sync with the card)."""
    global _enabled, _sync
    _enabled = on
    if sync is not None:
        _sync = sync


def _drain_device(device=None):
    """Wait for the card's queue (the current device's, or `device`'s);
    nothing to wait for on the CPU."""
    if device is not None and torch.device(device).type != "cuda":
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


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


@contextmanager
def span(name: str):
    """A nested scope of the profiler's tree (nothing when it is off)."""
    if not _enabled:
        yield
        return
    node = _stack[-1].child(name)
    _stack.append(node)
    if _sync:
        _drain_device()
    t0 = time.time()
    try:
        yield
    finally:
        if _sync:
            _drain_device()
        dt = time.time() - t0
        node.total += dt
        node.count += 1
        _stack.pop()
        print(f"[halo2_tpu]{'·' * (len(_stack) - 1)} {name}: {dt*1000:.1f} ms",
              file=sys.stderr, flush=True)


def report(file=None) -> str:
    """Render the accumulated timer tree and counters (and print them)."""
    out = []

    def walk(node, depth, parent_total):
        pct = (f" ({100 * node.total / parent_total:.0f}%)"
               if parent_total else "")
        out.append(f"{'  ' * depth}{node.name}: {node.total*1000:.1f} ms"
                   f" x{node.count}{pct}")
        for ch in node.children.values():
            walk(ch, depth + 1, node.total)

    for ch in _root.children.values():
        walk(ch, 0, 0.0)
    if counters:
        out.append("counters: " + ", ".join(
            f"{k}={v:g}" for k, v in sorted(counters.items())))
    text = "\n".join(out)
    print(text, file=file or sys.stderr, flush=True)
    return text


def reset():
    """Clear the counters and the profiler's tree."""
    global _root, _stack
    _root = _Node("total")
    _stack = [_root]
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


def phase_marker(device, phases: PhaseTimes | None = None,
                 scope: str = "prover"):
    """The caller's PhaseTimes, or a do-nothing marker when none is given;
    while the profiler is on, a marker that also records each mark's
    seconds into the tree under `scope` and prints them (its time taken
    after a wait for `device` when the profiler syncs)."""
    if phases is not None:
        phases._t = phases._now()
    if not _enabled:
        return phases if phases is not None else (lambda name: None)
    parent = _stack[-1].child(scope)
    state = {"t": time.time()}

    def mark(name: str):
        if phases is not None:
            phases(name)
        if _sync:
            _drain_device(device)
        now = time.time()
        dt = now - state["t"]
        node = parent.child(name)
        node.total += dt
        node.count += 1
        parent.total += dt
        print(f"[halo2_tpu] {name}: {dt*1000:.1f} ms", file=sys.stderr,
              flush=True)
        state["t"] = now

    return mark


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
