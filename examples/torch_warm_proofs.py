#!/usr/bin/env python3
"""Seconds of one cold and several warm proofs, phase by phase.

    python3 examples/torch_warm_proofs.py [--k 16] [--circuit mulchain]
                                          [--repeat 5]

Sets up and keys a circuit at 2^K rows (`mulchain`: MulChainCircuit, the
prove path's; `allargs`: AllArgsCircuit over every usable row, the args
path's; `allargs2`: two AllArgsCircuit instances in one SHPLONK proof,
the multi path's), then proves it 1 + REPEAT times and prints one JSON
line: each proof's wall seconds (host clock around work that ends in a
synchronise) with the prover's phase seconds, and the Python function
calls of one more proof under cProfile (the host work, which the card's
idle share says bounds these proofs).  Uses only functions every tree of
the port has, so it can be copied into an older tree to compare two trees
on one card.  Then the card's name and power limit.  Needs one CUDA
device.
"""

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.circuit import FlatFloorPlanner  # noqa: E402
from halo2_tpu_torch.circuits import AllArgsCircuit, MulChainCircuit  # noqa: E402,E501
from halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from halo2_tpu_torch.plonk.prover import create_proof_multi  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402
from halo2_tpu_torch.utils import profiling  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--circuit", default="mulchain",
                    choices=("mulchain", "allargs", "allargs2"))
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_warm_proofs: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    planner, opening = None, {}
    if args.circuit.startswith("allargs"):
        rows = AllArgsCircuit.usable_rows(args.k)
        circuits = [AllArgsCircuit(rows, seed=s) for s in
                    ((5, 6) if args.circuit == "allargs2" else (5,))]
        instances = [[[c.instance()]] for c in circuits]
        planner = FlatFloorPlanner
        if args.circuit == "allargs2":
            opening = {"use_gwc": False}
    else:
        circuits = [MulChainCircuit(MulChainCircuit.steps_for(args.k), a=3,
                                    b=5)]
        instances = [[[circuits[0].expected_out()]]]
    params = Params.unsafe_setup(args.k, seed=7, device=device)
    _, pk = keygen(params, circuits[0], floor_planner=planner, device=device)

    def prove(phases=None):
        create_proof_multi(params, pk, circuits, instances, seed=8,
                           floor_planner=planner, device=device,
                           phases=phases, **opening)
        torch.cuda.synchronize(device)

    proofs = []
    for _ in range(1 + args.repeat):
        phases = profiling.PhaseTimes(device)
        t0 = time.time()
        prove(phases)
        proofs.append({"s": round(time.time() - t0, 4),
                       "phases": {k: round(v, 4)
                                  for k, v in phases.seconds.items()}})
    prof = cProfile.Profile()
    prof.enable()
    prove()
    prof.disable()
    calls = pstats.Stats(prof).total_calls
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(json.dumps({"circuit": args.circuit, "k": args.k,
                      "cold": proofs[0], "warm": proofs[1:],
                      "warm_s": [p["s"] for p in proofs[1:]],
                      "python_calls_a_proof": calls}), flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
