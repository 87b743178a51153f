#!/usr/bin/env python3
"""Prover benchmark at 2^k rows on one card: seconds and peak device
memory of every phase, cold and warm — the port of
examples/bench_prover.py.

    python3 examples/torch_bench_prover.py [--k 22] [--circuit mulchain]
                                           [--offload] [--proofs 2]
                                           [--mesh D]

`--circuit mulchain` is halo2_tpu_torch.circuits.MulChainCircuit (a chain
of mul gates over 95 % of the rows, gates + permutation, GWC);
`allargs` is AllArgsCircuit over every usable row (lookup, shuffle, range
check, gate, permutation).  Runs Params.unsafe_setup, keygen (with its
phases) and `--proofs` proofs in one process (the first is cold, the rest
warm), each verified, with `--offload` passing offload_lagrange=True.
Each phase's peak allocated and reserved bytes are read at its end and the
device's peak statistics reset (utils.profiling.PhaseTimes(peaks=True)).
`--mesh D` proves (and keygens) with params.use_mesh over D shards on
cuda:(i % device_count) (all on the CPU with --device cpu), and adds each proof's peak allocated bytes on
every other card of the mesh.  Prints one JSON line per stage, the card's
name and power limit, and a summary line.  A CUDA out-of-memory error is a result: its stage, the
phases finished before it and the port's innermost frame are printed, and
the exit code is 3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.circuit import FlatFloorPlanner  # noqa: E402
from halo2_tpu_torch.circuits import AllArgsCircuit, MulChainCircuit  # noqa: E402
from halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from halo2_tpu_torch.plonk.prover import create_proof  # noqa: E402
from halo2_tpu_torch.plonk.verifier import verify_proof  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402
from halo2_tpu_torch.utils import profiling  # noqa: E402
from halo2_tpu_torch.utils.device import require_device  # noqa: E402
from halo2_tpu_torch.utils.mesh import Mesh  # noqa: E402


def circuit_for(name: str, k: int):
    """(circuit, instances, floor planner) of a benchmark circuit."""
    if name == "mulchain":
        c = MulChainCircuit(MulChainCircuit.steps_for(k), a=3, b=5)
        return c, [[c.expected_out()]], None
    if name == "allargs":
        c = AllArgsCircuit(AllArgsCircuit.usable_rows(k))
        return c, [[c.instance()]], FlatFloorPlanner
    raise ValueError(f"unknown circuit {name!r}")


def phase_record(pt: profiling.PhaseTimes) -> dict:
    return {name: {"seconds": round(s, 3), **pt.peaks.get(name, {})}
            for name, s in pt.seconds.items()}


def peak_of(pt: profiling.PhaseTimes, key: str):
    return max((p[key] for p in pt.peaks.values()), default=None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=22)
    ap.add_argument("--circuit", choices=("mulchain", "allargs"),
                    default="mulchain")
    ap.add_argument("--offload", action="store_true")
    ap.add_argument("--proofs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shards on cuda:(i % device_count); 0: one device")
    args = ap.parse_args()
    device = require_device(args.device)
    mesh = others = None
    if args.mesh:
        count = torch.cuda.device_count() if device.type == "cuda" else 1
        mesh = Mesh([torch.device("cuda", i % count)
                     if device.type == "cuda" else device
                     for i in range(args.mesh)])
        others = sorted({str(d) for d in mesh.flat} - {str(device)})
    circuit, instances, planner = circuit_for(args.circuit, args.k)
    head = {"k": args.k, "circuit": args.circuit, "offload": args.offload,
            "proofs": args.proofs,
            "mesh": [str(d) for d in mesh.flat] if mesh else None}
    print(json.dumps({"bench": head}), flush=True)
    summary = dict(head)
    stage, pt = "unsafe_setup", None
    try:
        pt = profiling.PhaseTimes(device, peaks=True)
        params = Params.unsafe_setup(args.k, seed=args.seed, device=device)
        params.use_mesh(mesh)
        pt("unsafe_setup")
        print(json.dumps({"unsafe_setup": phase_record(pt)}), flush=True)
        stage = "keygen"
        pt = profiling.PhaseTimes(device, peaks=True)
        vk, pk = keygen(params, circuit, floor_planner=planner,
                        device=device, phases=pt)
        resident = (torch.cuda.memory_allocated(device)
                    if device.type == "cuda" else None)
        print(json.dumps({"keygen": {
            "seconds": round(sum(pt.seconds.values()), 3),
            "phases": phase_record(pt),
            "allocated_after": resident}}), flush=True)
        summary["keygen_seconds"] = round(sum(pt.seconds.values()), 3)
        summary["proofs_seconds"], summary["proofs_peak"] = [], []
        pv = params.verifier(len(instances[0]))
        for i in range(args.proofs):
            stage = f"create_proof {i}"
            profiling.reset()
            for d in others or ():
                torch.cuda.reset_peak_memory_stats(d)
            pt = profiling.PhaseTimes(device, peaks=True)
            t0 = time.perf_counter()
            proof = create_proof(params, pk, circuit, instances,
                                 seed=args.seed + 1 + i,
                                 floor_planner=planner, device=device,
                                 phases=pt, offload_lagrange=args.offload)
            seconds = time.perf_counter() - t0
            counters = dict(profiling.counters)
            stage = f"verify_proof {i}"
            t0 = time.perf_counter()
            ok = verify_proof(pv, vk, instances, proof)
            verify_s = time.perf_counter() - t0
            peak = {"allocated": peak_of(pt, "allocated"),
                    "reserved": peak_of(pt, "reserved")}
            if others:
                peak["allocated_other_cards"] = {
                    d: torch.cuda.max_memory_allocated(d) for d in others}
            print(json.dumps({"proof": {
                "index": i, "cold": i == 0, "seconds": round(seconds, 3),
                "phases": phase_record(pt), "peak": peak,
                "allocated_after": (torch.cuda.memory_allocated(device)
                                    if device.type == "cuda" else None),
                "proof_bytes": len(proof), "verified": ok,
                "verify_seconds": round(verify_s, 3),
                "counters": {key: counters.get(key, 0) for key in (
                    "ntt_calls", "ntt_streamed_calls", "lagrange_offloads",
                    "msm_calls", "msm_window_groups")}}}), flush=True)
            if not ok:
                raise AssertionError(f"proof {i} was rejected")
            summary["proofs_seconds"].append(round(seconds, 3))
            summary["proofs_peak"].append(peak)
    except torch.cuda.OutOfMemoryError as err:
        frames = [f for f in traceback.extract_tb(err.__traceback__)
                  if "halo2_tpu_torch" in f.filename]
        where = frames[-1] if frames else None
        print(json.dumps({"oom": {
            "stage": stage,
            "phases_done": list(pt.seconds) if pt else [],
            "raised_in": (f"{os.path.relpath(where.filename)}:{where.lineno}"
                          f" {where.name}") if where else None,
            "message": str(err).splitlines()[0]}}), flush=True)
        summary["oom_stage"] = stage
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        summary["card"] = smi.stdout.strip().splitlines()[0]
        print(summary["card"], flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 3 if "oom_stage" in summary else 0


if __name__ == "__main__":
    sys.exit(main())
