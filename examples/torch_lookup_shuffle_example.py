#!/usr/bin/env python3
"""Logup lookups and a shuffle end to end on the port (the reference's
lookup_api.rs / shuffle_api.rs class): LookupShuffleCircuit checked by
MockProver on the host, then keygen, create_proof and verify_proof on
`--device` (default the card), with a broken shuffle rejected.

    python3 examples/torch_lookup_shuffle_example.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from halo2_tpu_torch.circuits import LookupShuffleCircuit  # noqa: E402
from halo2_tpu_torch.dev import MockProver  # noqa: E402
from halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from halo2_tpu_torch.plonk.prover import create_proof  # noqa: E402
from halo2_tpu_torch.plonk.verifier import verify_proof  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402

K = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    va, vb = LookupShuffleCircuit.VALS_A, LookupShuffleCircuit.VALS_B
    MockProver.run(K, LookupShuffleCircuit(va, vb), []).assert_satisfied()
    print("MockProver satisfied")
    params = Params.unsafe_setup(K, seed=9, device=args.device)
    vk, pk = keygen(params, LookupShuffleCircuit(), device=args.device)
    proof = create_proof(params, pk, LookupShuffleCircuit(va, vb), [],
                         seed=3, device=args.device)
    print(f"proof: {len(proof)} bytes")
    if not verify_proof(params.verifier(1), vk, [], proof):
        raise AssertionError("the proof was rejected")
    print("VALID")
    bad_b = [5] + vb[1:]          # in the table, but not a shuffle of a
    bad = create_proof(params, pk, LookupShuffleCircuit(va, bad_b), [],
                       seed=3, device=args.device)
    if verify_proof(params.verifier(1), vk, [], bad):
        raise AssertionError("a broken shuffle was accepted")
    print("broken shuffle rejected")


if __name__ == "__main__":
    main()
