"""Reduction of a torch.profiler trace to what the per-layer metrics read:
device time by kernel name, kernel launches, the union of the intervals in
which anything ran on the device (kernels, copies, fills: overlapping
operations of two streams count once), and the idle gaps between them,
each named by what the host was doing at its midpoint: the innermost host
operation the profiler recorded there (a PyTorch op, a CUDA runtime call),
or the benchmark's own `host:` annotation around the witness load or the
prover where no such operation ran (the host's Python and numpy)."""

from __future__ import annotations

import heapq

ANNOTATIONS = ("host:", "trace:")


def _device_events(prof):
    """(name, start_ns, end_ns, is_kernel) of every device-side event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        # the benchmark's own annotations are mirrored on the device's
        # timeline: they are ranges of the host, not device work
        if name.startswith(ANNOTATIONS):
            continue
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            kernel = not name.startswith(("Memcpy", "Memset", "Memory"))
            out.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                        kernel))
    return out


def short(name: str) -> str:
    """A kernel's name without its parameter list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if i else name
    return name


def _host_events(prof):
    """(name, start_ns, end_ns) of every host-side event."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CPU")]


def union(intervals) -> list:
    """Merged [start, end) intervals, in order."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def host_op_at(host, points) -> list:
    """For each time in `points` (ascending), the name of the host event
    that started last among those running then (the innermost, as host
    events nest), or None."""
    host = sorted(host, key=lambda e: e[1])
    active, out, j = [], [], 0
    for t in points:
        while j < len(host) and host[j][1] <= t:
            name, start, end = host[j]
            heapq.heappush(active, (-start, end, name))
            j += 1
        # an event that ended before t has ended before every later point
        while active and active[0][1] < t:
            heapq.heappop(active)
        out.append(active[0][2] if active else None)
    return out


def _label(name):
    if name is None:
        return "between proofs"
    if name.startswith("host:"):
        return name[len("host:"):] + ", no torch op"
    return name


def reduce(prof) -> dict:
    """What the trace shows within its `trace:window` annotation:
    {"kernels": {name: seconds}, "launches", "busy_s", "window_s",
    "idle_by_host_op": {what the host did: idle seconds}}."""
    host = _host_events(prof)
    (t0_ns, t1_ns), = [(a, b) for n, a, b in host if n == "trace:window"]
    events = [(n, max(a, t0_ns), min(b, t1_ns), k)
              for n, a, b, k in _device_events(prof) if b > t0_ns and a < t1_ns]
    kernels = {}
    for name, a, b, is_kernel in events:
        name = short(name)
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-9
    busy = union([(a, b) for _, a, b, _ in events])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    # idle gaps: the window minus the busy intervals
    gaps, cur = [], t0_ns
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1_ns > cur:
        gaps.append((cur, t1_ns))
    host = [e for e in host if not e[0].startswith("trace:")]
    names = host_op_at(host, [(a + b) / 2 for a, b in gaps])
    idle = {}
    for (a, b), name in zip(gaps, names):
        label = _label(name)
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return {"kernels": kernels,
            "launches": sum(1 for *_, k in events if k),
            "busy_s": busy_s, "window_s": (t1_ns - t0_ns) * 1e-9,
            "idle_by_host_op": idle}
