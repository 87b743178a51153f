#!/usr/bin/env python3
"""Host cost of a field-kernel launch, and wall time of the chains the
prover runs, for the halo2_tpu_torch found beside this script.

    python3 examples/torch_launch_cost.py

Uses only functions every version of the package has (`Field.mul`,
`Field.inv`, `Field.prefix_mul`, `Field.batch_inverse`, `g1.scalar_mul`,
`g1.add`, `msm._combine_windows`, `g1.to_affine`, `cuda_ops.butterfly`,
`cuda_ops.mul_tiled`, `cuda_point.add_mixed_packed`), so the same script
measures two trees side by side (copy it into the other tree's examples/
and run it there).  Prints one JSON line:

  host_us    host microseconds a call, over 1,000 calls and one
             synchronize: Field.mul (K1) on one element and on (16, 2^16),
             and on one element (one row of one column for K2 and K3) each
             of butterfly (K2), mul_tiled (K3), g1.add (K4) and
             add_mixed_packed (K5): with the device work this small, the
             host's cost of a launch;
  wall_ms    host clock around one call and a synchronize (median of 5
             after a warm call): inv of one element, prefix_mul and
             batch_inverse at 2^16, the Horner combine of the proof's
             widest MSM batch (4 lanes, 24 windows, c = 11), scalar_mul and
             to_affine of 2^16 points.

Needs one CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.curves import cuda_point, g1  # noqa: E402
from halo2_tpu_torch.fields import cuda_ops  # noqa: E402
from halo2_tpu_torch.fields.bn254 import fq, fr  # noqa: E402
from halo2_tpu_torch.fields.limbs import N_LIMBS  # noqa: E402
from halo2_tpu_torch.msm import msm  # noqa: E402
from halo2_tpu_torch.msm.sorted import pack_xy  # noqa: E402


def host_us(fn, calls=1000) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def wall_ms(fn, reps=5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rand(F, n, gen, device):
    x = torch.randint(0, 1 << 16, (N_LIMBS, n), dtype=torch.int32,
                      device=device, generator=gen)
    x[N_LIMBS - 1] &= 0x0FFF
    x[0] |= 1
    return x


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_launch_cost: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    F, Q = fr(device), fq(device)
    n = 1 << 16
    a1, b1 = rand(F, 1, gen, device), rand(F, 1, gen, device)
    a, b = rand(F, n, gen, device), rand(F, n, gen, device)
    base = tuple(c[:, None].expand(N_LIMBS, n).contiguous()
                 for c in g1.generator(device))
    scal = rand(F, n, gen, device)
    scal[N_LIMBS - 1] &= 0x3FFF
    proj = g1.scalar_mul(base, scal)
    totals = tuple(c[:, :96].reshape(N_LIMBS, 4, 24).contiguous()
                   for c in proj)
    p1 = tuple(c[:, :1].contiguous() for c in proj)
    aff1 = g1.to_affine(p1)
    packed1, sign1 = pack_xy(*aff1), torch.ones(1, dtype=torch.int32,
                                                 device=device)
    row = rand(F, 2, gen, device).reshape(N_LIMBS, 1, 2)
    lo, hi = row[:, :, :1], row[:, :, 1:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {
        "card": smi, "tree": os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
        "host_us": {
            "mul_n1": host_us(lambda: F.mul(a1, b1)),
            "mul_n65536": host_us(lambda: F.mul(a, b)),
            "butterfly_n1": host_us(
                lambda: cuda_ops.butterfly(F, lo, hi, a1, 1)),
            "mul_tiled_n1": host_us(
                lambda: cuda_ops.mul_tiled(F, a1[:, None], a1)),
            "point_add_n1": host_us(lambda: g1.add(p1, p1)),
            "add_mixed_packed_n1": host_us(
                lambda: cuda_point.add_mixed_packed(p1, packed1, sign1))},
        "wall_ms": {
            "inv_n1": wall_ms(lambda: F.inv(a1)),
            "inv_fq_n1": wall_ms(lambda: Q.inv(a1)),
            "prefix_mul_n65536": wall_ms(lambda: F.prefix_mul(a)),
            "batch_inverse_n65536": wall_ms(lambda: F.batch_inverse(a)),
            "combine_windows_4x24": wall_ms(
                lambda: msm._combine_windows(totals, 11)),
            "scalar_mul_n65536": wall_ms(
                lambda: g1.scalar_mul(base, scal), 3),
            "to_affine_n65536": wall_ms(lambda: g1.to_affine(proj), 3),
        }}
    print(json.dumps({"launch_cost": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
