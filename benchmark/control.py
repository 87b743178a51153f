"""The control of the comparison that decides `correct`: the same run with
one guarantee of the configuration broken, which has to come out not
correct.  The guarantee broken is the witness's: after create_witness has
stored it, one cell of advice column 0 at a usable row drawn from the seed
is raised by one, so the stored witness no longer satisfies the circuit.
The program proves it as it proves any witness.

    python3 benchmark/control.py --workload NAME --seeds 11,12,13
                                 [--seconds 5] [--sound]

prints one JSON line a run, {"workload", "seed", "run": "control" or
"sound", "correct", the numbers compared}; --sound runs each seed
unbroken too, in the same process."""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def corrupt(path: str, seed: int, usable: int) -> None:
    """Raise one value of column 0, at a usable row from `seed`, by one
    (mod p) in a stored witness file (a u32 column count, then per column
    n little-endian 32-byte values)."""
    from benchmark.reference.bn254 import R
    row = random.Random(seed).randrange(2, usable)
    with open(path, "r+b") as fh:
        fh.seek(4 + 32 * row)
        v = int.from_bytes(fh.read(32), "little")
        fh.seek(4 + 32 * row)
        fh.write(((v + 1) % R).to_bytes(32, "little"))


def broken_witnesses(seed: int):
    """A context in which create_witness stores broken witnesses."""
    from contextlib import contextmanager

    from halo2_tpu_torch.plonk import prover

    @contextmanager
    def ctx():
        real = prover.create_witness

        def create_witness(pk, circuit, instances, path, floor_planner=None):
            real(pk, circuit, instances, path, floor_planner)
            corrupt(path, seed, pk.vk.cs.usable_rows(1 << pk.vk.k))
        prover.create_witness = create_witness
        try:
            yield
        finally:
            prover.create_witness = real
    return ctx()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args()
    sys.path[0] = ROOT
    from benchmark import harness
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        runs = (("sound", False), ("control", True)) if args.sound \
            else (("control", True),)
        for label, broken in runs:
            t = time.perf_counter()
            if broken:
                with broken_witnesses(seed):
                    result, compared = harness.run(
                        args.workload, seed, args.seconds, False, t)
            else:
                result, compared = harness.run(args.workload, seed,
                                               args.seconds, False, t)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "run": label, "correct": result["correct"],
                              "proofs": result["attempted"],
                              **{n: v for n, v, _ in compared}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
