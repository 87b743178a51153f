#!/usr/bin/env python3
"""The batch inversion's chain on the card: its kernels, design by design.

    python3 examples/torch_chain_probe.py [--label TEXT] [--reps N]

Times each call by CUDA events around N calls replayed from a CUDA graph
(`device_ms`, no host in the way) and prints one JSON line a measurement:

  * `Field.inv` and Fermat's power `Field.pow_static(a, p - 2)`, Fr and
    Fq, at n = 1 (`batch_inverse`'s total) and n = 2^16, each result held
    equal to the other;
  * `Field.prefix_mul` forward and reverse at n = 2^16 and 2^18 (lengths
    `chip_smoke.py` times at k = 16), 5 * 2^16 (between them and the
    large path's, no power of two) and 2^22 (the large path's), and,
    where the tree's scan has run lengths (`cuda_ops.SCAN_PER_THREAD`),
    at every run length through the kernel's C entry `h2_scan`, each
    held equal to the default plan's result;
  * `Field.batch_inverse` (two scans, one inversion and the glue) at 2^16
    and 2^18.

It calls only functions every tree of the port has (the run-length sweep
where the tree has one), so a copy of an older tree can run it in the same
call: parent, change, change, parent.  Needs one CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.fields import cuda_ops  # noqa: E402
from halo2_tpu_torch.fields.bn254 import fq, fr  # noqa: E402
from halo2_tpu_torch.fields.limbs import N_LIMBS  # noqa: E402
from halo2_tpu_torch.utils import build, profiling  # noqa: E402

SCAN_LENGTHS = (1 << 16, 1 << 18, 5 << 16, 1 << 22)
BATCH_INVERSE_LENGTHS = (1 << 16, 1 << 18)


def _rand(F, n, gen):
    """n random canonical Montgomery-form elements, none zero."""
    raw = torch.randint(0, 1 << 16, (N_LIMBS, n), dtype=torch.int32,
                        device=F.device, generator=gen)
    raw[N_LIMBS - 1] &= 0x0FFF                   # below 2^252 < p
    raw[0] |= 1
    return raw


def _scan_at(F, a, reverse, V):
    """cuda_ops.prefix_mul with the run length V in place of the plan's:
    the same launch of `h2_scan`, on tiles of SCAN_BLOCK * V elements."""
    n = a.shape[1]
    tiles = -(-n // (cuda_ops.SCAN_BLOCK * V))
    out = torch.empty((N_LIMBS, n), dtype=torch.int32, device=a.device)
    a0, a_es = cuda_ops.scan_origin(n, a.stride(1), reverse)
    o0, o_es = cuda_ops.scan_origin(n, 1, reverse)
    state = torch.empty(17 * tiles + 1, dtype=torch.int32, device=a.device)
    build.launch(a.device, cuda_ops._lib().h2_scan,
                 cuda_ops._FIELD_IDS[F.name], V, a.data_ptr() + 4 * a0,
                 a.stride(0), a_es, out.data_ptr() + 4 * o0, n, o_es, n,
                 state.data_ptr(), tiles)
    return out


def _emit(label, what, **fields):
    print(json.dumps({"label": label, "what": what, **fields}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_chain_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    build.build_all()
    gen = torch.Generator(device=device)
    gen.manual_seed(10)
    label, reps = args.label, args.reps

    def time_of(fn):
        return profiling.time_graph(fn, reps)

    for F in (fr(device), fq(device)):
        for n in (1, 1 << 16):
            a = _rand(F, n, gen)
            same = torch.equal(F.inv(a), F.pow_static(a, F.p - 2))
            _emit(label, "inv", field=F.name, n=n, equal_to_fermat=same,
                  inv_device_ms=time_of(lambda: F.inv(a)),
                  fermat_device_ms=time_of(lambda: F.pow_static(a, F.p - 2)))
            if not same:
                return 1
    F = fr(device)
    sweep = getattr(cuda_ops, "SCAN_PER_THREAD", ())
    for n in SCAN_LENGTHS:
        a = _rand(F, n, gen)
        for reverse in (False, True):
            want = F.prefix_mul(a, reverse)
            row = {"n": n, "reverse": reverse,
                   "device_ms": time_of(lambda: F.prefix_mul(a, reverse))}
            if sweep:
                row["plan"] = cuda_ops.scan_plan(n)
                for v in sweep:
                    if not torch.equal(_scan_at(F, a, reverse, v), want):
                        _emit(label, "scan", n=n, per_thread=v, equal=False)
                        return 1
                    row[f"device_ms_v{v}"] = time_of(
                        lambda: _scan_at(F, a, reverse, v))
            _emit(label, "scan", **row)
        del a, want
    for n in BATCH_INVERSE_LENGTHS:
        a = _rand(F, n, gen)
        _emit(label, "batch_inverse", n=n,
              device_ms=time_of(lambda: F.batch_inverse(a)))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
