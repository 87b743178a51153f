#!/usr/bin/env python3
"""A range check by a sorted column on the port (the reference's
range-check.rs): `circuits.RangeCheckCircuit` at K = 5 through
unsafe_setup, keygen, create_proof and verify_proof on `--device`
(default the card).

    python3 examples/torch_range_check_example.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from halo2_tpu_torch.circuits import RangeCheckCircuit  # noqa: E402
from halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from halo2_tpu_torch.plonk.prover import create_proof  # noqa: E402
from halo2_tpu_torch.plonk.verifier import verify_proof  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402

K = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    params = Params.unsafe_setup(K, seed=13, device=args.device)
    vk, pk = keygen(params, RangeCheckCircuit(), device=args.device)
    proof = create_proof(params, pk, RangeCheckCircuit(
        RangeCheckCircuit.VALUES), [], device=args.device)
    print(f"proof: {len(proof)} bytes")
    ok = verify_proof(params.verifier(1), vk, [], proof)
    print("VALID" if ok else "INVALID")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
