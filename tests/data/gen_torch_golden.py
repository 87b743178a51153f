#!/usr/bin/env python3
"""Generate tests/data/torch_golden_proof.json from the JAX package.

    JAX_PLATFORMS=cpu python3 tests/data/gen_torch_golden.py

Proves `tests/test_e2e.py`'s SimpleCircuit (K = 4, Params.unsafe_setup
seed 7, a = 3, b = 5) with halo2_tpu for the prover seeds 0 and 1 and
writes the proof bytes as hex, beside the bytes of `Params.write`, the
pinned verifying key and the transcript hash of the verifying key.  The
port must reproduce these: `chip_smoke.py` checks the proofs on the card,
tests/test_torch_prover.py checks all of them on the CPU and pins the file
against the live JAX package.
"""

import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import tests.conftest  # noqa: E402,F401  (the test suite's JAX settings)
from halo2_tpu.plonk.keygen import keygen  # noqa: E402
from halo2_tpu.plonk.prover import create_proof  # noqa: E402
from halo2_tpu.poly.commitment import Params  # noqa: E402
from halo2_tpu.transcript import Blake2bWrite  # noqa: E402
from tests.test_e2e import K, SimpleCircuit, expected_out  # noqa: E402

PARAMS_SEED = 7
A, B = 3, 5
PROVER_SEEDS = (0, 1)


def params_bytes(params) -> bytes:
    buf = io.BytesIO()
    params.write(buf)
    return buf.getvalue()


def vk_hash(vk, transcript_cls) -> bytes:
    """The transcript state after absorbing the vk, squeezed to bytes."""
    t = transcript_cls()
    vk.hash_into(t)
    return t.squeeze_challenge().to_bytes(32, "little")


def golden_of(params, vk, proofs) -> dict:
    """The golden record of the JAX package's SRS, key and proofs."""
    return {"circuit": "tests/test_e2e.py::SimpleCircuit", "k": K,
            "params_seed": PARAMS_SEED, "a": A, "b": B,
            "params_hex": params_bytes(params).hex(),
            "pinned_vk": vk.pinned(),
            "vk_hash_hex": vk_hash(vk, Blake2bWrite).hex(),
            "proofs": {str(s): p.hex() for s, p in proofs.items()}}


def main():
    params = Params.unsafe_setup(K, seed=PARAMS_SEED)
    vk, pk = keygen(params, SimpleCircuit())
    out = expected_out(A, B)
    proofs = {s: create_proof(params, pk, SimpleCircuit(A, B), [[out]],
                              seed=s) for s in PROVER_SEEDS}
    golden = golden_of(params, vk, proofs)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_golden_proof.json")
    with open(path, "w") as fh:
        json.dump(golden, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    main()
