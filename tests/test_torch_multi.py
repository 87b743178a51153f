"""The port's multi-circuit proofs (create_proof_multi /
verify_proof_multi) against the JAX package, on the CPU.

  * tests/test_e2e.py::test_multi_instance_proof: two SimpleCircuit
    instances (K = 4, params seed 7, prover seed 11) in one GWC proof,
    byte-identical to the JAX package's, accepted, and rejected with the
    instances swapped or a byte flipped;
  * tests/test_plonk_api.py's two-instance proofs (K = 5, params seed 42,
    prover seed 0, a lookup, gates, copies, an instance; the port's copy
    of its circuit, halo2_tpu_torch.circuits.PlonkApiCircuit), GWC and
    SHPLONK:
    the port's pinned vk, its verifier on the JAX proofs, an altered
    instance rejected, and BatchVerifier across a vk file round trip (the
    e2e proof's too); the
    port's own proof bytes of these two (two instances at K = 5 cost about
    a minute each on the CPU) are marked slow, and chip_smoke.py's golden
    phase checks them on the card.

Tolerance: none — proof bytes are compared for equality with
tests/data/torch_golden_multi.json (written by
tests/data/gen_torch_golden.py from the JAX package).
"""

import json
import os

import pytest
import torch

from tests.data.torch_golden_circuits import multi_circuits

from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P
from halo2_tpu_torch.io import load_vk, save_vk
from halo2_tpu_torch.multiopen import BatchVerifier
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.prover import create_proof_multi
from halo2_tpu_torch.plonk.verifier import verify_proof_multi
from halo2_tpu_torch.poly.commitment import Params

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_multi.json")
PLONK_API = ["plonk_api_multi_gwc", "plonk_api_multi_shplonk"]
ALL = ["e2e_multi_gwc"] + PLONK_API


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


class _Keys(dict):
    """The port's params and key of each record's circuit, made at first
    use (the two plonk_api records share one)."""

    def __init__(self, golden):
        super().__init__()
        self.golden = golden

    def __missing__(self, name):
        rec = self.golden["proofs"][name]
        empty, _ = multi_circuits(name, rec)
        key = (rec["k"], rec["params_seed"])
        for other in list(self.values()):
            if other["key"] == key:
                self[name] = other
                return other
        params = Params.unsafe_setup(rec["k"], seed=rec["params_seed"],
                                     device="cpu")
        vk, pk = keygen(params, empty, device="cpu")
        side = self[name] = {"key": key, "params": params, "vk": vk,
                             "pk": pk}
        return side


@pytest.fixture(scope="module")
def keys(golden):
    return _Keys(golden)


def _prove(keys, golden, name):
    rec = golden["proofs"][name]
    side = keys[name]
    return create_proof_multi(side["params"], side["pk"],
                              multi_circuits(name, rec)[1], rec["instances"],
                              seed=rec["prover_seed"],
                              use_gwc=rec["use_gwc"], device="cpu")


def _rejects(pv, vk, instances, proof, use_gwc) -> bool:
    try:
        return not verify_proof_multi(pv, vk, instances, proof,
                                      use_gwc=use_gwc)
    except ValueError:
        return True


def test_multi_instance_proof_bytes_equal(keys, golden):
    rec = golden["proofs"]["e2e_multi_gwc"]
    assert _prove(keys, golden, "e2e_multi_gwc").hex() == rec["proof_hex"]


@pytest.mark.slow
@pytest.mark.parametrize("name", PLONK_API)
def test_plonk_api_proof_bytes_equal(keys, golden, name):
    assert _prove(keys, golden, name).hex() == \
        golden["proofs"][name]["proof_hex"]


@pytest.mark.parametrize("name", ALL)
def test_pinned_vk_equal(keys, golden, name):
    assert keys[name]["vk"].pinned() == golden["proofs"][name]["pinned_vk"]


@pytest.mark.parametrize("name", ALL)
def test_port_verifier_accepts_and_rejects(keys, golden, name):
    """The JAX proof is accepted; with the instances swapped (the e2e
    record's differ) or one altered, or with a byte flipped, rejected."""
    rec = golden["proofs"][name]
    side = keys[name]
    pv = side["params"].verifier(1)
    proof = bytes.fromhex(rec["proof_hex"])
    insts = rec["instances"]
    assert verify_proof_multi(pv, side["vk"], insts, proof,
                              use_gwc=rec["use_gwc"])
    bad = ([insts[1], insts[0]] if insts[0] != insts[1]
           else [insts[0], [[(insts[1][0][0] + 1) % P]]])
    assert _rejects(pv, side["vk"], bad, proof, rec["use_gwc"])
    flipped = bytearray(proof)
    flipped[-40] ^= 1
    assert _rejects(pv, side["vk"], insts, bytes(flipped), rec["use_gwc"])
    # one proof's worth of instances reads another transcript
    assert _rejects(pv, side["vk"], insts[:1], proof, rec["use_gwc"])


@pytest.mark.parametrize("names", [["e2e_multi_gwc"], PLONK_API],
                         ids=["e2e", "plonk_api"])
def test_batch_verifier_across_a_vk_reload(keys, golden, tmp_path, names):
    """plonk_api.rs:437-512: the proofs of one key into one BatchVerifier,
    the second time with the vk written and read back; one pairing check
    accepts them, and an altered instance among them fails it."""
    side = keys[names[0]]
    pv = side["params"].verifier(1)
    path = str(tmp_path / "vk.bin")
    save_vk(side["vk"], path)
    empty, _ = multi_circuits(names[0], golden["proofs"][names[0]])
    vk2 = load_vk(side["params"], empty, path)
    assert vk2.pinned() == side["vk"].pinned()
    batch, bad_batch = BatchVerifier(seed=5), BatchVerifier(seed=5)
    for name in names:
        rec = golden["proofs"][name]
        proof = bytes.fromhex(rec["proof_hex"])
        for vk in (side["vk"], vk2):
            verify_proof_multi(pv, vk, rec["instances"], proof,
                               use_gwc=rec["use_gwc"], strategy=batch)
        bad = [rec["instances"][0], [[(rec["instances"][1][0][0] + 1) % P]]]
        verify_proof_multi(pv, vk2, bad if name == names[-1]
                           else rec["instances"], proof,
                           use_gwc=rec["use_gwc"], strategy=bad_batch)
    assert batch.finalize(pv)
    assert not bad_batch.finalize(pv)
