#!/usr/bin/env python3
"""Where one halo2_tpu_torch proof spends its time on the card.

    python3 examples/torch_profile_prove.py [--k K] [--circuit NAME]
                                            [--show TEXT]

Sets up and keys a circuit at 2^K rows (`mulchain`, the default: the
row-filling MulChainCircuit, gates + permutation; `allargs`:
AllArgsCircuit over every usable row, every argument of the proof system,
with FlatFloorPlanner), proves once to warm up, then proves again under torch.profiler (CPU + CUDA activities)
and prints one JSON object: the proof's wall seconds, the summed device
time of all kernels, the device's busy share of the wall time, the ten
kernels with the most device time, the launches and device time of all
kernels and of PyTorch's elementwise kernels (names holding
"elementwise"), and with --show every kernel whose name contains TEXT
(e.g. `scan_` for the three passes of the prefix-product scan).  With the
default circuit it uses only functions every tree of the port has, so it
can be copied into an older tree to compare.  Needs one CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from halo2_tpu_torch.circuits import MulChainCircuit  # noqa: E402
from halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from halo2_tpu_torch.plonk.prover import create_proof  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--circuit", choices=("mulchain", "allargs"),
                    default="mulchain")
    ap.add_argument("--show", default=None,
                    help="also list every kernel whose name contains this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_prove: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    planner = None
    if args.circuit == "allargs":
        from halo2_tpu_torch.circuit import FlatFloorPlanner
        from halo2_tpu_torch.circuits import AllArgsCircuit
        circuit = AllArgsCircuit(AllArgsCircuit.usable_rows(args.k))
        instances, planner = [[circuit.instance()]], FlatFloorPlanner
    else:
        circuit = MulChainCircuit(MulChainCircuit.steps_for(args.k), a=3,
                                  b=5)
        instances = [[circuit.expected_out()]]
    params = Params.unsafe_setup(args.k, seed=7, device=device)
    _, pk = keygen(params, circuit, floor_planner=planner, device=device)
    create_proof(params, pk, circuit, instances, seed=1,
                 floor_planner=planner, device=device)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        create_proof(params, pk, circuit, instances, seed=2,
                     floor_planner=planner, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only: an operator's entry repeats the device time
    # of the kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_s = sum(r[1] for r in rows) / 1e6
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)

    def listed(picked):
        return [{"name": n[:80], "device_ms": round(t / 1e3, 3), "calls": c}
                for n, t, c in picked]

    def summed(picked):
        picked = list(picked)
        return {"launches": sum(r[2] for r in picked),
                "device_ms": round(sum(r[1] for r in picked) / 1e3, 3)}
    out = {"card": smi.stdout.strip().splitlines()[0], "k": args.k,
           "circuit": args.circuit,
           "create_proof_wall_s": round(wall, 4),
           "device_time_s": round(device_s, 4),
           "device_busy_share": round(device_s / wall, 4),
           "all_kernels": summed(rows),
           "pytorch_elementwise": summed(
               r for r in rows if "elementwise" in r[0]),
           "top_kernels": listed(rows[:10])}
    if args.show:
        out["shown_kernels"] = listed(r for r in rows if args.show in r[0])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
