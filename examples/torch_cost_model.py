#!/usr/bin/env python3
"""Proof-cost model on the card: the port's counterpart of the reference's
examples/cost-model.rs and of examples/cost_model.py.

    python3 examples/torch_cost_model.py --circuit allargs --k 16 [--prove]
    python3 examples/torch_cost_model.py --k 14 --advice 0,1 --advice 0 \\
        --fixed 0 --gate-degree 3 --lookup 2,1,1 --permutation 3

Times the port's MSM (`Params.commit_lagrange` over 2^k points of the
SRS, full 254-bit scalars) and NTT (`NTT.forward` at 2^k and at the
extended domain's 2^ext_k) with CUDA events on the card, and combines
them with CircuitCost's counts as cost_model.py does: prover seconds =
MSMs x MSM(2^k) + NTTs x NTT(2^k) + extended-NTT equivalents x
NTT(2^ext_k).  `--circuit` names a circuit of halo2_tpu_torch/circuits.py
at 2^k rows (allargs, mulchain or blockchain); without it the circuit is
built from the column, rotation, lookup and permutation flags (the
reference's CLI).  `--prove` then runs keygen and two create_proof calls
of that circuit on the card and prints the measured seconds beside the
estimate.  Prints one JSON line, then the card's name and power limit.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.circuit import FlatFloorPlanner  # noqa: E402
from halo2_tpu_torch.circuits import (AllArgsCircuit,  # noqa: E402
                                      BlockMulChainCircuit, MulChainCircuit)
from halo2_tpu_torch.dev import CircuitCost  # noqa: E402
from halo2_tpu_torch.fields.bn254 import fr  # noqa: E402
from halo2_tpu_torch.ntt.ntt import get_ntt  # noqa: E402
from halo2_tpu_torch.plonk.circuit import ConstraintSystem  # noqa: E402
from halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from halo2_tpu_torch.plonk.prover import create_proof  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402
from halo2_tpu_torch.utils.profiling import time_cuda  # noqa: E402

REPS = 5


def named_circuit(name: str, k: int):
    """(circuit with its witness, instances, floor planner) at 2^k rows."""
    if name == "allargs":
        c = AllArgsCircuit(AllArgsCircuit.usable_rows(k))
        return c, [[c.instance()]], FlatFloorPlanner
    if name == "mulchain":
        c = MulChainCircuit(MulChainCircuit.steps_for(k), a=3, b=5)
        return c, [[c.expected_out()]], None
    if name == "blockchain":
        c = BlockMulChainCircuit(BlockMulChainCircuit.steps_for(k, 64), 64,
                                 3, 1000003)
        return c, [[c.expected_out()]], FlatFloorPlanner
    raise ValueError(f"unknown circuit {name!r}")


def synthetic_cs(args) -> ConstraintSystem:
    """A constraint system from the column, rotation, lookup and
    permutation flags (cost-model.rs CostOptions)."""
    cs = ConstraintSystem()
    advice = [cs.advice_column() for _ in args.advice]
    instance = [cs.instance_column() for _ in args.instance]
    fixed = [cs.fixed_column() for _ in args.fixed]

    def gate(m):
        polys = [m.query_advice(c, r) for c, spec in zip(advice, args.advice)
                 for r in spec]
        polys += [m.query_instance(c, r)
                  for c, spec in zip(instance, args.instance) for r in spec]
        polys += [m.query_fixed(c, r) for c, spec in zip(fixed, args.fixed)
                  for r in spec]
        expr = polys[0]
        for p in polys[1:min(len(polys), max(args.gate_degree, 1))]:
            expr = expr * p
        for p in polys:
            expr = expr + p
        return [("cost", expr)]

    cs.create_gate("cost", gate)
    for ncols, _, _ in args.lookup:
        ins = advice[:max(1, min(ncols, len(advice)))]
        tabs = fixed[:len(ins)] or ins
        cs.lookup_any("cost-lookup", lambda m, i=ins, t=tabs: list(zip(
            [m.query_advice(c, 0) for c in i],
            [m.query_fixed(c, 0) if c.ctype == "fixed"
             else m.query_advice(c, 0) for c in t])))
    for ncols in args.permutation:
        for col in (advice + fixed + instance)[:ncols]:
            cs.enable_equality(col)
    cs.chunk_lookups()
    cs.chunk_shuffles()
    return cs


def measure(k: int, ext_k: int, device) -> dict:
    """ms of one MSM over 2^k SRS points, one NTT at 2^k and one at
    2^ext_k, by CUDA events around REPS calls after a warm one."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    rng = random.Random(1)
    F = fr(device)
    params = Params.unsafe_setup(k, seed=7, device=device)
    scalars = F.encode([rng.randrange(F.p) for _ in range(1 << k)])
    out = {"msm_ms": time_cuda(lambda: params.commit_lagrange(scalars), REPS)}
    for key, size in (("ntt_ms", k), ("ext_ntt_ms", ext_k)):
        x = torch.randint(0, 1 << 16, (16, 1 << size), dtype=torch.int32,
                          generator=gen).to(device)
        x[15] &= 0x0FFF                      # below p
        ntt = get_ntt(size, device)
        out[key] = time_cuda(lambda: ntt.forward(x), REPS)
    return out


def prove(name: str, k: int, device) -> dict:
    """Seconds of keygen and of two create_proof calls (the second one
    warm) of the named circuit, host clock around synchronised work."""
    circuit, instances, planner = named_circuit(name, k)
    params = Params.unsafe_setup(k, seed=7, device=device)
    t0 = time.time()
    vk, pk = keygen(params, circuit, floor_planner=planner, device=device)
    torch.cuda.synchronize(device)
    out = {"keygen_s": time.time() - t0, "create_proof_s": []}
    for seed in (1, 2):
        t0 = time.time()
        create_proof(params, pk, circuit, instances, seed=seed,
                     floor_planner=planner, device=device)
        torch.cuda.synchronize(device)
        out["create_proof_s"].append(time.time() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    rot = lambda s: [int(r) for r in s.split(",")]  # noqa: E731
    tri = lambda s: tuple(int(r) for r in s.split(","))  # noqa: E731
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--circuit", choices=("allargs", "mulchain",
                                          "blockchain"))
    ap.add_argument("--prove", action="store_true",
                    help="also prove the named circuit and print its time")
    ap.add_argument("--advice", type=rot, action="append", default=[])
    ap.add_argument("--instance", type=rot, action="append", default=[])
    ap.add_argument("--fixed", type=rot, action="append", default=[])
    ap.add_argument("--gate-degree", type=int, default=2)
    ap.add_argument("--lookup", type=tri, action="append", default=[],
                    metavar="N,I,T")
    ap.add_argument("--permutation", type=int, action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_cost_model: no CUDA device", file=sys.stderr)
        return 2
    if args.prove and not args.circuit:
        ap.error("--prove needs --circuit")
    device = torch.device("cuda", 0)
    if args.circuit:
        circuit, _, planner = named_circuit(args.circuit, args.k)
        cost = CircuitCost.measure(args.k, circuit, floor_planner=planner)
    else:
        args.advice = args.advice or [[0]]
        cs = synthetic_cs(args)
        cost = CircuitCost.of_cs(args.k, cs, cs.degree())
    t = measure(args.k, cost.extended_k, device)
    n_msm, n_ntt = cost.prover_msms(), cost.prover_ntts()
    # extended-domain work (cost_model.py:239-250): one coset NTT a column
    # the quotient reads, and about one a permutation set, lookup and
    # shuffle
    n_ext = (cost.advice_columns + cost.fixed_columns + cost.instance_columns
             + cost.permutation_columns + cost.permutation_sets
             + 3 * cost.lookups + cost.shuffle_groups)
    estimate = (n_msm * t["msm_ms"] + n_ntt * t["ntt_ms"]
                + n_ext * t["ext_ntt_ms"]) / 1e3
    out = {"circuit": args.circuit or "synthetic", "k": args.k,
           "extended_k": cost.extended_k, "degree": cost.max_degree,
           "measured_ms": t, "msms": n_msm, "ntts": n_ntt,
           "ext_ntt_equivalents": n_ext,
           "proof_size_gwc_bytes": cost.proof_size_gwc(),
           "prover_estimate_s": estimate}
    if args.prove:
        out["measured"] = prove(args.circuit, args.k, device)
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
