#!/usr/bin/env python3
"""Standard-PLONK end to end on the port (the reference's
simple-example.rs class): a custom mul gate, copy constraints, a constant
and one public input (`circuits.SimpleCircuit`), through unsafe_setup,
keygen, create_proof and verify_proof on `--device` (default the card),
with the seconds of verify_proof (a fresh process verifies with the G2
line cache cold the first time, warm after).

    python3 examples/torch_simple_example.py [k] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from halo2_tpu_torch.circuits import SimpleCircuit  # noqa: E402
from halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from halo2_tpu_torch.plonk.prover import create_proof  # noqa: E402
from halo2_tpu_torch.plonk.verifier import verify_proof  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("k", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"setup k={args.k} ...")
    params = Params.unsafe_setup(args.k, seed=42, device=args.device)
    print("keygen ...")
    vk, pk = keygen(params, SimpleCircuit(), device=args.device)
    a, b = 3, 5
    out = SimpleCircuit.expected_out(a, b)
    print("prove ...")
    proof = create_proof(params, pk, SimpleCircuit(a, b), [[out]],
                         device=args.device)
    print(f"proof: {len(proof)} bytes")
    print("verify ...")
    t0 = time.perf_counter()
    ok = verify_proof(params.verifier(1), vk, [[out]], proof)
    print(f"verify_proof: {time.perf_counter() - t0:.4f} s (host; the G2 "
          f"lines from HALO2_TPU_G2_CACHE when it holds them)")
    print("VALID" if ok else "INVALID")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
