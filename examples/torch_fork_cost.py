#!/usr/bin/env python3
"""What a fork costs the parallel witness synthesis on this machine.

    python3 examples/torch_fork_cost.py [--k 16] [--blocks 64]
                                        [--workers 1 2 4 8]

plonk/parallel_synthesis.py forks one process a worker, and each fork
copies the page tables of the prover process.  This times an empty fork
(fork, the child's os._exit, waitpid; the mean of 8) after the imports,
and again after Params.unsafe_setup and keygen on the card, with the
process's resident set beside each; then synthesize_witness of
BlockMulChainCircuit at 2^k rows (the chip_smoke.py synth path's circuit)
with each worker count, twice in turns.  Prints one JSON line, then the
card's name and power limit.  Needs one CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.circuit import FlatFloorPlanner  # noqa: E402
from halo2_tpu_torch.circuits import BlockMulChainCircuit  # noqa: E402
from halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from halo2_tpu_torch.plonk.prover import synthesize_witness  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402


def fork_ms(count: int = 8) -> float:
    """Mean ms of fork + the child's os._exit + waitpid."""
    t0 = time.time()
    for _ in range(count):
        pid = os.fork()
        if pid == 0:
            os._exit(0)
        os.waitpid(pid, 0)
    return (time.time() - t0) / count * 1e3


def rss_mb() -> dict:
    """VmRSS and its anonymous and file-backed parts, MB."""
    out = {}
    with open("/proc/self/status") as fh:
        for line in fh:
            key = line.split(":")[0]
            if key in ("VmRSS", "RssAnon", "RssFile"):
                out[key] = int(line.split()[1]) / 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fork_cost: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = {"k": args.k, "blocks": args.blocks, "cpu_count": os.cpu_count(),
           "cpus_available": len(os.sched_getaffinity(0)),
           "after_imports": {"fork_ms": fork_ms(), "rss_mb": rss_mb()}}
    steps = BlockMulChainCircuit.steps_for(args.k, args.blocks)

    def circuit(workers):
        return BlockMulChainCircuit(steps, args.blocks, 3, 1000003,
                                    workers=workers)
    params = Params.unsafe_setup(args.k, seed=7, device=device)
    _, pk = keygen(params, circuit(1), floor_planner=FlatFloorPlanner,
                   device=device)
    torch.cuda.synchronize(device)
    out["after_keygen"] = {"fork_ms": fork_ms(), "rss_mb": rss_mb()}
    instances = [[circuit(1).expected_out()]]
    seconds = {w: [] for w in args.workers}
    for _ in range(2):
        for w in args.workers:
            t0 = time.time()
            synthesize_witness(pk, circuit(w), instances, FlatFloorPlanner)
            seconds[w].append(round(time.time() - t0, 4))
    out["synthesize_witness_s"] = {str(w): s for w, s in seconds.items()}
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
