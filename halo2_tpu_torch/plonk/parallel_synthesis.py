"""Parallel witness synthesis: the fork's raw-pointer rayon fan-out.

The reference's FlatFloorPlanner + WitnessCollection let zkWasm-scale
circuits synthesize regions in parallel, every rayon task writing through
an unlocked ``*mut [F]`` pointer into the shared advice buffers
(prover.rs:1525-1781; regions sit at absolute offsets, so no relocation or
coordination is needed, flat.rs:286-336).  Python threads cannot do that
(the GIL serialises the per-cell assignment work that dominates
synthesis), so this is the POSIX equivalent:

  * the u64 advice columns move into **anonymous shared memory**
    (`WitnessCollection.share_columns`) before the fan-out;
  * region closures go round-robin to **forked worker processes**: a
    child inherits the shared mappings, so every worker writes its
    regions' cells straight into the final column buffers, with no copy
    and no pickling of the circuit;
  * each worker's bookkeeping (max row and value a column, deferred
    `Assigned` rationals, the cells whose value needs 2^64 or more or
    whose column is degraded, the regions' return values) is all that
    comes back, over a pipe, and the parent merges it.

The regions' writes must be disjoint: that is the circuit author's
contract, as in the reference.  Aliased u64 writes within one worker are
last-wins; the order of a u64 write and an overflow or deferred write to
the same cell is undefined (direct writes land at once, the others are
replayed by the parent after the join).  Regions must not use
`constrain_constant` (the constants cursor is a sequential allocator; the
keygen pass, where constants land, never runs in parallel).

**The fork rule.**  On the card, keygen has run before synthesis, so the
parent holds a CUDA context and torch's CPU thread pools when it forks.  A
child that touches CUDA fails ("Cannot re-initialize CUDA in forked
subprocess") and a child that runs a torch CPU op can deadlock on a pool
lock it inherited.  So the workers run numpy and Python only: regions,
their closures and the cells they return hold no tensor, and results must
pickle (else they come back as None).  A child leaves by `os._exit`,
skipping torch's atexit teardown, with its garbage collector off.

Entry point: ``layouter.assign_regions(name, fns)`` (circuit/__init__.py)
routes here when the backend supports it; otherwise the same call runs the
closures in turn, so circuits written against this API run unchanged under
MockProver, keygen and the V1 planner.  The worker count is the call's
`workers`, else `default_workers()`: the environment variable
HALO2_TORCH_SYNTH_WORKERS, else the CPUs the process may run on, at most
16.
"""

import os
import pickle
import struct

import numpy as np

from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.plonk.error import NotEnoughRowsAvailable, SynthesisError
from halo2_tpu_torch.utils import profiling

_ENV_WORKERS = "HALO2_TORCH_SYNTH_WORKERS"


def default_workers() -> int:
    """HALO2_TORCH_SYNTH_WORKERS if set, else the CPUs this process may run
    on (os.cpu_count() where the affinity mask cannot be read), at most
    16."""
    v = os.environ.get(_ENV_WORKERS)
    if v:
        return max(1, int(v))
    try:
        cpus = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cpus = os.cpu_count() or 1
    return min(cpus, 16)


class _WorkerCollection:
    """Assignment backend for one forked worker: writes u64-representable
    values directly into the shared columns; records everything else
    (big values, deferred rationals, bookkeeping) for the parent merge."""

    def __init__(self, cs, n, usable_rows, instances, shared_cols, p):
        self.cs = cs
        self.n = n
        self.usable_rows = usable_rows
        self.instances = instances
        self.advice = shared_cols          # list[np.ndarray (shm) | None]
        self.p = p
        self.max_assigned = [-1] * len(shared_cols)
        self.max_value = [0] * len(shared_cols)
        self.deferred = []                 # (ci, row, num, den)
        self.overflow = {}                 # ci -> ([row], [int value])

    # Assignment protocol --------------------------------------------------
    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def enable_selector(self, selector, row):
        pass

    def assign_fixed(self, column, row, value):
        pass

    def copy(self, left, right):
        pass

    def fill_from_row(self, column, from_row, value):
        raise SynthesisError(
            "table regions cannot be assigned inside parallel regions")

    def query_instance(self, column, row):
        return self.instances[column.index][row]

    def is_in_prove_mode(self):
        return True

    def _overflow(self, ci, row, v):
        rows, values = self.overflow.setdefault(ci, ([], []))
        rows.append(row)
        values.append(v)

    def _note(self, ci, row, v):
        if row > self.max_assigned[ci]:
            self.max_assigned[ci] = row
        if v > self.max_value[ci]:
            self.max_value[ci] = v

    def assign_advice(self, column, row, value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.n.bit_length() - 1)
        if value is None:
            raise SynthesisError("advice value not assigned (synthesis)")
        from halo2_tpu_torch.plonk.assigned import Assigned
        ci = column.index
        if isinstance(value, Assigned) and not (value.is_trivial()
                                                or value.is_zero()):
            self.deferred.append((ci, row, value.num, value.den))
            if row > self.max_assigned[ci]:
                self.max_assigned[ci] = row
            return
        v = int(value) % self.p
        col = self.advice[ci]
        if col is None or v >> 64:
            # degraded-to-bigint column, or a value the u64 buffer cannot
            # hold: ship the exact value back to the parent
            self._overflow(ci, row, v)
        else:
            col[row] = v
        self._note(ci, row, v)

    def assign_advice_bulk(self, column, from_row, values):
        count = len(values)
        if from_row + count > self.usable_rows:
            raise NotEnoughRowsAvailable(self.n.bit_length() - 1)
        ci = column.index
        col = self.advice[ci]
        arr = None
        if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
            if values.dtype.kind == "i" and count and int(values.min()) < 0:
                values = [int(v) % self.p for v in values]
            else:
                arr = values.astype(np.uint64, copy=False)
        if arr is None:
            try:
                arr = np.asarray(values, dtype=np.uint64)
            except (OverflowError, TypeError, ValueError):
                arr = None
        if arr is not None and col is not None:
            col[from_row: from_row + count] = arr
            vmax = int(arr.max()) if count else 0
        else:
            vals = ([int(v) % self.p for v in values] if arr is None
                    else [int(v) for v in arr])
            for i, v in enumerate(vals):
                if col is None or v >> 64:
                    self._overflow(ci, from_row + i, v)
                else:
                    col[from_row + i] = v
            vmax = max(vals, default=0)
        if count:
            self._note(ci, from_row + count - 1, vmax)


class _WorkerLayouterShim:
    """Just enough of SingleChipLayouter for a worker's _RegionLayouters:
    high-water marks collapse to a per-column max (shipped to the parent),
    constants are forbidden (sequential allocator lives in the parent)."""

    def __init__(self, backend):
        self.backend = backend
        self.high_water = {}               # column/selector -> max row + 1

    def mark(self, column, row):
        cur = self.high_water.get(column, 0)
        if row + 1 > cur:
            self.high_water[column] = row + 1

    def constrain_constant(self, cell, constant):
        raise SynthesisError(
            "constrain_constant is not allowed inside parallel regions "
            "(sequential constants allocator; assign constants outside "
            "the parallel fan-out)")


def _read_exact(fd, size):
    buf = bytearray()
    while len(buf) < size:
        chunk = os.read(fd, size - len(buf))
        if not chunk:
            raise SynthesisError("parallel synthesis worker died")
        buf += chunk
    return bytes(buf)


def _picklable(res):
    try:
        pickle.dumps(res)
        return res
    except Exception:
        return None


def run_parallel_regions(layouter, fns, workers=None):
    """Execute region closures across forked workers; returns their results
    in order.  `layouter` is a flat-mode SingleChipLayouter over a
    WitnessCollection; the collection's columns are switched to shared
    memory in place (share_columns) so worker writes land in the final
    buffers."""
    from halo2_tpu_torch.circuit import Region, _RegionLayouter

    backend = layouter.backend
    workers = min(workers or default_workers(), len(fns))
    profiling.incr("synth_fan_outs")
    profiling.incr("synth_workers", workers)
    shared_cols = backend.share_columns()
    try:
        return _fan_out(layouter, backend, fns, workers, shared_cols,
                        Region, _RegionLayouter, FR_MODULUS)
    finally:
        # drop the shm-backed views BEFORE unshare so shm.close() actually
        # releases the mappings here (not later via GC)
        shared_cols = None
        backend.unshare_columns()


def _fan_out(layouter, backend, fns, workers, shared_cols, Region,
             _RegionLayouter, p):
    pipes = []
    pids = []
    for w in range(workers):
        r, wfd = os.pipe()
        pid = os.fork()
        if pid == 0:
            # ---- child ----
            os.close(r)
            status = 1
            # gc in a forked child COW-faults every inherited object page
            # (the collector writes PyGC_Head marks heap-wide — the
            # Instagram gc.freeze problem); workers are short-lived and
            # exit via os._exit, so cycles never need collecting
            import gc
            gc.disable()
            try:
                wc = _WorkerCollection(backend.cs, backend.n,
                                       backend.usable_rows,
                                       backend.instances, shared_cols, p)
                shim = _WorkerLayouterShim(wc)
                results = []
                for i in range(w, len(fns), workers):
                    rl = _RegionLayouter(shim, 0)
                    results.append((i, _picklable(fns[i](Region(rl)))))
                payload = pickle.dumps(
                    {"results": results,
                     "high_water": list(shim.high_water.items()),
                     "max_assigned": wc.max_assigned,
                     "max_value": wc.max_value,
                     "deferred": wc.deferred,
                     "overflow": wc.overflow},
                    protocol=pickle.HIGHEST_PROTOCOL)
                status = 0
            except BaseException as e:  # ship the error, don't hang parent
                payload = pickle.dumps({"error": repr(e)},
                                       protocol=pickle.HIGHEST_PROTOCOL)
            try:
                os.write(wfd, struct.pack("<Q", len(payload)))
                off = 0
                while off < len(payload):
                    off += os.write(wfd, payload[off:])
                os.close(wfd)
            finally:
                # skip atexit and torch's teardown: the child must not
                # touch the inherited CUDA context
                os._exit(status)
        os.close(wfd)
        pipes.append(r)
        pids.append(pid)

    # ---- parent: collect + merge ----
    states = []
    err = None
    for r, pid in zip(pipes, pids):
        try:
            (size,) = struct.unpack("<Q", _read_exact(r, 8))
            state = pickle.loads(_read_exact(r, size))
        except Exception as e:
            # a worker killed mid-write (OOM) yields a truncated or corrupt
            # payload — struct.error / UnpicklingError, not just
            # SynthesisError; convert to a per-worker error so the
            # remaining children are still reaped below
            state = {"error": repr(e)}
        finally:
            os.close(r)
        os.waitpid(pid, 0)
        if "error" in state and err is None:
            err = state["error"]
        states.append(state)
    if err is not None:
        raise SynthesisError(f"parallel region failed: {err}")

    results = [None] * len(fns)
    for st in states:
        for ci in range(len(backend.max_assigned)):
            if st["max_assigned"][ci] > backend.max_assigned[ci]:
                backend.max_assigned[ci] = st["max_assigned"][ci]
            if st["max_value"][ci] > backend.max_value[ci]:
                backend.max_value[ci] = st["max_value"][ci]
        backend.deferred.extend(st["deferred"])
        for ci, (rows, values) in st["overflow"].items():
            backend.assign_advice_big(ci, rows, values)
        for col, hw in st["high_water"]:
            layouter.mark(col, hw - 1)
        for i, res in st["results"]:
            results[i] = res
    return results
