#!/usr/bin/env python3
"""The SRS setup on the card, by phase, and the kernels it and a params
load run.

    python3 examples/torch_setup_probe.py [--label TEXT] [--ks 16,20,22]
                                          [--reps N]

Prints one JSON line a measurement:

  * `Params.unsafe_setup(k)` for each k (the first k also once more,
    warm), its seconds split at the calls it makes: `scalars` up to the
    first point multiplication (`g1.scalar_mul` or `g1.fixed_base_mul`),
    `g` up to the second, `g_lagrange` up to `pairing.g2_mul`, `s_g2` to
    the end; the card is synchronised at every mark.  Where the tree's
    `unsafe_setup` takes `phases`, its own split is printed beside it;
  * device ms (CUDA-graph replays, no host in the way) of the scalar
    ladder `g1.scalar_mul` and, where the tree has it, the fixed-base comb
    `g1.fixed_base_mul`, at 2^16 and 2^22 setup-like scalars, their
    affine points held equal; the comb also on scalars whose 32 bytes are
    all 1 (the same 32 adds, but every thread of a window reads one table
    row: what the rows' reads from L2 cost); and of
    `Fq.pow_static(a, (q + 1) / 4)`, the square roots of a params file's
    points, at (16, 2^16) and (16, 2^22).

It calls only functions that older trees of the port have too (the comb
and the setup's own split where the tree has them), so a copy of an older
tree can run it in the same call: parent, change, change, parent.  Needs
one CUDA device.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.curves import g1  # noqa: E402
from halo2_tpu_torch.fields.bn254 import fq  # noqa: E402
from halo2_tpu_torch.fields.limbs import N_LIMBS  # noqa: E402
from halo2_tpu_torch.pairing import bn254 as pairing  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402
from halo2_tpu_torch.utils import build, profiling  # noqa: E402

KERNEL_LOG_NS = (16, 22)
SEED = 7


def _emit(label, what, **fields):
    print(json.dumps({"label": label, "what": what, **fields}), flush=True)


class _Marks:
    """Wraps the functions unsafe_setup calls between its phases: each
    call synchronises the card and records when it began."""

    def __init__(self):
        self.t = []
        self.saved = []

    def wrap(self, mod, name):
        orig = getattr(mod, name, None)
        if orig is None:
            return

        def wrapped(*args, _orig=orig, **kw):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())
            return _orig(*args, **kw)
        self.saved.append((mod, name, orig))
        setattr(mod, name, wrapped)

    def restore(self):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def _setup(k, device):
    """unsafe_setup(k) with the call marks, and its own split where it
    takes `phases`: (params, {phase: seconds}, {phase: seconds} or None)."""
    marks = _Marks()
    for name in ("scalar_mul", "fixed_base_mul"):
        marks.wrap(g1, name)
    marks.wrap(pairing, "g2_mul")
    own = None
    kw = {}
    if "phases" in inspect.signature(Params.unsafe_setup).parameters:
        own = profiling.PhaseTimes(device)
        kw["phases"] = own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        params = Params.unsafe_setup(k, seed=SEED, device=device, **kw)
        torch.cuda.synchronize()
    finally:
        marks.restore()
    end = time.perf_counter()
    m1, m2, m3 = marks.t[:3]
    split = {"scalars": m1 - t0, "g": m2 - m1, "g_lagrange": m3 - m2,
             "s_g2": end - m3, "total": end - t0}
    return params, split, (own.seconds if own is not None else None)


def _scalars(n, gen, device):
    """(16, n) standard-form limbs of random 254-bit scalars."""
    s = torch.randint(0, 1 << 16, (N_LIMBS, n), dtype=torch.int32,
                      device=device, generator=gen)
    s[N_LIMBS - 1] &= 0x3FFF
    return s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--ks", default="16,20,22")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_setup_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    build.build_all()
    label = args.label
    ks = [int(k) for k in args.ks.split(",")]
    for i, k in enumerate(ks + ks[:1]):
        params, split, own = _setup(k, device)
        _emit(label, "unsafe_setup", k=k, warm=i > 0 and k == ks[0],
              seconds=split, own_phases=own,
              peak_allocated=torch.cuda.max_memory_allocated(device))
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    gx, gy = g1.generator(device)
    for log_n in KERNEL_LOG_NS:
        n = 1 << log_n
        reps = args.reps if log_n <= 16 else 2
        s = _scalars(n, gen, device)
        base = (gx[:, None].expand(N_LIMBS, n),
                gy[:, None].expand(N_LIMBS, n))
        row = {"n": n, "ladder_device_ms": profiling.time_graph(
            lambda: g1.scalar_mul(base, s), reps)}
        if hasattr(g1, "fixed_base_mul"):
            same = torch.equal(
                torch.stack(g1.to_affine(g1.fixed_base_mul(s))),
                torch.stack(g1.to_affine(g1.scalar_mul(base, s))))
            row["fixed_base_device_ms"] = profiling.time_graph(
                lambda: g1.fixed_base_mul(s), reps)
            row["affine_equal"] = same
            ones = torch.full_like(s, 0x0101)
            row["fixed_base_one_row_device_ms"] = profiling.time_graph(
                lambda: g1.fixed_base_mul(ones), reps)
            del ones
            if not same:
                _emit(label, "point_mul", **row)
                return 1
        _emit(label, "point_mul", **row)
        del s
        F = fq(device)
        e = (F.p + 1) // 4
        a = _scalars(n, gen, device)
        a[N_LIMBS - 1] &= 0x0FFF                 # below 2^252 < q
        _emit(label, "pow_sqrt", n=n, field="Fq", device_ms=(
            profiling.time_graph(lambda: F.pow_static(a, e),
                                 args.reps if log_n <= 16 else 5)))
        del a
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
