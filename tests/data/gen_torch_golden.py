#!/usr/bin/env python3
"""Generate tests/data/torch_golden_proof.json and
tests/data/torch_golden_horner.json from the JAX package.

    JAX_PLATFORMS=cpu python3 tests/data/gen_torch_golden.py

Proves `tests/test_e2e.py`'s SimpleCircuit (K = 4, Params.unsafe_setup
seed 7, a = 3, b = 5) with halo2_tpu for the prover seeds 0 and 1 and
writes the proof bytes as hex, beside the bytes of `Params.write`, the
pinned verifying key and the transcript hash of the verifying key.  The
port must reproduce these: `chip_smoke.py` checks the proofs on the card,
tests/test_torch_prover.py checks all of them on the CPU and pins the file
against the live JAX package.

The second file holds the MSM's Horner combine over windows
(`halo2_tpu.msm.msm._combine_windows`, c = 4, three windows, two lanes,
one of them with an identity window) on numpy-seeded projective points:
the projective limbs the port's `_combine_windows` must reproduce
(tests/test_torch_chains.py).  The JAX call compiles for about 20 s on
the CPU, so the tests read its result from here.
"""

import importlib
import io
import json
import os
import sys

import numpy as np

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
HORNER_C, HORNER_W, HORNER_LANES, HORNER_SEED = 4, 3, 2, 3


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


def horner_inputs():
    """lanes x windows projective points (X, Y, Z) as canonical ints: random
    multiples of the generator with a random Z; lane 1's window 1 is the
    identity (0 : 1 : 0)."""
    from halo2_tpu.curves import host
    from halo2_tpu.fields.bn254 import FQ_MODULUS as Q
    rng = np.random.default_rng(HORNER_SEED)
    lanes = []
    for lane in range(HORNER_LANES):
        wins = []
        for w in range(HORNER_W):
            if (lane, w) == (1, 1):
                wins.append([0, 1, 0])
                continue
            k = int.from_bytes(rng.bytes(32), "little")
            z = int.from_bytes(rng.bytes(40), "little") % (Q - 1) + 1
            x, y = host.mul(host.G1_GEN, k)
            wins.append([x * z % Q, y * z % Q, z])
        lanes.append(wins)
    return lanes


def horner_golden() -> dict:
    """The JAX package's Horner combine of `horner_inputs()`, per lane, as
    the integers its Montgomery limb words spell."""
    from halo2_tpu.fields.bn254 import Fq
    from halo2_tpu.fields.limbs import limbs_to_int
    jmsm = importlib.import_module("halo2_tpu.msm.msm")
    lanes = horner_inputs()
    out = []
    for wins in lanes:
        totals = tuple(Fq.encode([p[i] for p in wins]) for i in range(3))
        acc = jmsm._combine_windows(totals, HORNER_C)
        out.append([limbs_to_int(np.asarray(c)) for c in acc])
    return {"c": HORNER_C, "windows": HORNER_W, "seed": HORNER_SEED,
            "inputs": lanes, "outputs_mont_words": out}


def _write(name: str, record: dict):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main():
    _write("torch_golden_horner.json", horner_golden())
    params = Params.unsafe_setup(K, seed=PARAMS_SEED)
    vk, pk = keygen(params, SimpleCircuit())
    out = expected_out(A, B)
    proofs = {s: create_proof(params, pk, SimpleCircuit(A, B), [[out]],
                              seed=s) for s in PROVER_SEEDS}
    _write("torch_golden_proof.json", golden_of(params, vk, proofs))


if __name__ == "__main__":
    main()
