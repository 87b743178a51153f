#!/usr/bin/env python3
"""Keygen benchmark: keygen twice in one process at 2^k rows, with its
phases — the port of examples/bench_keygen.py.

    python3 examples/torch_bench_keygen.py [--k 22] [--circuit mulchain]

The first keygen pays the one-time costs (the NTT tables, the codec's
build); the second shows what a keygen costs on its own.  Each phase's
seconds (synchronising with the card at every mark) and peak allocated and
reserved bytes are printed as one JSON line per run, then the card's name
and power limit.  The circuits are those of examples/torch_bench_prover.py.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402
from halo2_tpu_torch.utils import profiling  # noqa: E402
from halo2_tpu_torch.utils.device import require_device  # noqa: E402

from examples.torch_bench_prover import circuit_for, phase_record  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=22)
    ap.add_argument("--circuit", choices=("mulchain", "allargs"),
                    default="mulchain")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = require_device(args.device)
    circuit, _, planner = circuit_for(args.circuit, args.k)
    pt = profiling.PhaseTimes(device, peaks=True)
    params = Params.unsafe_setup(args.k, seed=args.seed, device=device)
    pt("unsafe_setup")
    print(json.dumps({"unsafe_setup": phase_record(pt)}), flush=True)
    for run in ("cold", "warm"):
        gc.collect()
        pt = profiling.PhaseTimes(device, peaks=True)
        vk, pk = keygen(params, circuit, floor_planner=planner,
                        device=device, phases=pt)
        print(json.dumps({"keygen": {
            "run": run, "k": args.k, "circuit": args.circuit,
            "seconds": round(sum(pt.seconds.values()), 3),
            "phases": phase_record(pt)}}), flush=True)
        del vk, pk
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
