#!/usr/bin/env python3
"""Where one halo2_tpu_torch proof spends its time on the card.

    python3 examples/torch_profile_prove.py [--k K] [--circuit NAME]
                                            [--shplonk] [--show TEXT]

Sets up and keys a circuit at 2^K rows (`mulchain`, the default: the
row-filling MulChainCircuit, gates + permutation; `allargs`:
AllArgsCircuit over every usable row, every argument of the proof system,
with FlatFloorPlanner; `allargs2`: two AllArgsCircuit instances, witness
seeds 5 and 6, in one proof through create_proof_multi), opened with GWC
or, with --shplonk, SHPLONK; proves once to warm up, then proves again
under torch.profiler (CPU + CUDA activities) and prints one JSON object:
the proof's wall seconds, the summed device time of all kernels, the
device's busy share of the wall time, the ten kernels with the most
device time, the launches and device time of all
kernels and of PyTorch's elementwise kernels (names holding
"elementwise"), and with --show every kernel whose name contains TEXT
(e.g. `scan_` for the prefix-product scan, `inv_` for the inversion).  With the
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
    ap.add_argument("--circuit", choices=("mulchain", "allargs", "allargs2"),
                    default="mulchain")
    ap.add_argument("--shplonk", action="store_true",
                    help="open with SHPLONK instead of GWC")
    ap.add_argument("--show", default=None,
                    help="also list every kernel whose name contains this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_prove: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    planner = None
    if args.circuit.startswith("allargs"):
        from halo2_tpu_torch.circuit import FlatFloorPlanner
        from halo2_tpu_torch.circuits import AllArgsCircuit
        rows = AllArgsCircuit.usable_rows(args.k)
        circuits = [AllArgsCircuit(rows, seed=s) for s in
                    ((5, 6) if args.circuit == "allargs2" else (5,))]
        instances = [[[c.instance()]] for c in circuits]
        planner = FlatFloorPlanner
    else:
        circuits = [MulChainCircuit(MulChainCircuit.steps_for(args.k), a=3,
                                    b=5)]
        instances = [[[circuits[0].expected_out()]]]
    opening = {"use_gwc": False} if args.shplonk else {}

    def prove(seed):
        if len(circuits) > 1:
            from halo2_tpu_torch.plonk.prover import create_proof_multi
            return create_proof_multi(params, pk, circuits, instances,
                                      seed=seed, floor_planner=planner,
                                      device=device, **opening)
        return create_proof(params, pk, circuits[0], instances[0], seed=seed,
                            floor_planner=planner, device=device, **opening)

    params = Params.unsafe_setup(args.k, seed=7, device=device)
    _, pk = keygen(params, circuits[0], floor_planner=planner, device=device)
    prove(1)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove(2)
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
           "opening": "shplonk" if args.shplonk else "gwc",
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
