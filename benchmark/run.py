"""Benchmark of halo2_tpu_torch: proofs from stored witnesses on one card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs the cell NAME of BENCHMARK.json: set-up (kernel build or cache hit,
Params.unsafe_setup, keygen, the witness files, one warm-up proof), then a
closed loop of proofs for S seconds (the proof under way when they pass is
finished and counted), then the comparison with the plain reference
(benchmark/reference/).  The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error.  --trace 1 reports the per-layer metrics instead of the
end-to-end ones.  Exits 2 without a result when the cell's cards are
missing, and 3 when JAX or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # the repository's root, not benchmark/, heads the import path
    sys.path[0] = ROOT
    # a library the port uses must not pull JAX in behind it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    from benchmark import harness
    import torch

    bench = harness.load_benchmark(ROOT)
    cell, _ = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, compared = harness.run(args.workload, args.seed, args.seconds,
                                   bool(args.trace), T_START, bench=bench)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: JAX modules loaded: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, value, limit in compared:
        print(f"{name} {value} limit {limit}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
