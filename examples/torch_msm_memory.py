#!/usr/bin/env python3
"""Peak device memory of the MSM's window totals, per point and window.

    python3 examples/torch_msm_memory.py [--k 18 20] [--groups 24 12]

For each n = 2^k and group size G: random affine coordinates and random
254-bit scalars on the card (what the scan holds does not depend on the
values), then one `msm.sorted.window_totals` over the 24 windows of c = 11
in groups of G, between `torch.cuda.reset_peak_memory_stats` and
`torch.cuda.max_memory_allocated`.  Prints one JSON line per (k, G): the
peak above what was allocated before the call, and that peak over G * n,
the bytes a point and window that `GROUP_BYTES_PER_POINT_WINDOW` stands
for; then the card's name and power limit.  Uses only functions every
tree of the port has, so it can be copied into an older tree to compare.
Needs one CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.fields.limbs import N_LIMBS  # noqa: E402
from halo2_tpu_torch.msm import sorted as msm_sorted  # noqa: E402

C, BLOCK, BITS = 11, 2048, 254


def _limbs(n, gen, device, top_mask):
    x = torch.randint(0, 1 << 16, (N_LIMBS, n), dtype=torch.int32,
                      device=device, generator=gen)
    x[N_LIMBS - 1] &= top_mask
    return x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, nargs="+", default=[18, 20])
    ap.add_argument("--groups", type=int, nargs="+", default=[24, 12])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_msm_memory: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    for k in args.k:
        n = 1 << k
        px, py = (_limbs(n, gen, device, 0x0FFF) for _ in range(2))
        scalars = _limbs(n, gen, device, 0x0FFF)       # below 2^252 < r
        for group in args.groups:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            out = msm_sorted.window_totals(px, py, scalars, BITS, group,
                                           BLOCK, C)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) - base
            del out
            print(json.dumps({"k": k, "n": n, "group": group,
                              "windows": msm_sorted.num_windows_for(BITS, C),
                              "peak_bytes": peak,
                              "bytes_per_point_window":
                                  round(peak / (group * n), 2)}),
                  flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
