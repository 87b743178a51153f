"""The port's logup / shuffle / range-check slice as a whole against the
JAX package, on the CPU: keygen -> create_proof(use_gwc=True) ->
verify_proof for tests/test_lookup_shuffle.py's LookupShuffleCircuit
(K = 5, params seed 99, prover seed 3), tests/test_range_check.py's
RangeCheckCircuit (K = 5, seed 21, prover seed 4) and
examples/bench_all_args.py's AllArgsCircuit (K = 9, seed 7, prover seed 0,
FlatFloorPlanner), through the port's copies in halo2_tpu_torch.circuits.

Tolerance: none — pinned verifying keys and proof bytes are compared for
equality with tests/data/torch_golden_args.json (written by
tests/data/gen_torch_golden.py), which one test holds against the live JAX
package.  The K = 9 AllArgsCircuit costs its SRS, keygen and proof some
minutes on the CPU, and a live JAX proof some minutes of XLA compiles:
those cases are marked slow, and `chip_smoke.py`'s golden phase checks the
port's bytes of every circuit on the card.  One live JAX fixture
(LookupShuffleCircuit's key) serves the JAX verifier, the carried key and
the golden checks; a test worker that runs none of those makes no JAX
call.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from halo2_tpu.plonk.keygen import keygen as j_keygen
from halo2_tpu.plonk.prover import create_proof as j_create_proof
from halo2_tpu.plonk.verifier import verify_proof as j_verify_proof
from halo2_tpu.poly.commitment import Params as JParams
from tests.data import gen_torch_golden as gen
from tests.data.torch_golden_circuits import argument_circuit
from tests.test_plonk_api import (INSTANCE, LOOKUP_TABLE, A_VALUE,
                                  MyCircuit as PlonkApiCircuit)

from halo2_tpu_torch import convert
from halo2_tpu_torch.circuits import LookupShuffleCircuit, RangeCheckCircuit
from halo2_tpu_torch.plonk.keygen import keygen, rebuild_cs
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.commitment import Params

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_args.json")
GOLDEN_MULTI = os.path.join(os.path.dirname(GOLDEN), "torch_golden_multi.json")
SLOW = pytest.mark.slow
CIRCUITS = ["lookup_shuffle", "range_check",
            pytest.param("all_args", marks=SLOW)]


class _Side(dict):
    """The port's params, key and golden-seed proof per circuit, each made
    at its first use."""

    def __init__(self, golden):
        super().__init__()
        self.golden = golden

    def __missing__(self, name):
        rec = self.golden["proofs"][name]
        circuit, planner = argument_circuit(name, rec["k"])
        params = Params.unsafe_setup(rec["k"], seed=rec["params_seed"],
                                     device="cpu")
        vk, pk = keygen(params, circuit, floor_planner=planner, device="cpu")
        side = self[name] = {"params": params, "vk": vk, "pk": pk,
                             "circuit": circuit, "planner": planner,
                             "rec": rec}
        return side

    def proof(self, name):
        side = self[name]
        if "proof" not in side:
            rec = side["rec"]
            side["proof"] = create_proof(
                side["params"], side["pk"], side["circuit"], rec["instances"],
                seed=rec["prover_seed"], floor_planner=side["planner"],
                device="cpu")
        return side["proof"]


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def port(golden):
    return _Side(golden)


@pytest.fixture(scope="module")
def jax_side(golden):
    """The JAX package's SRS and key of LookupShuffleCircuit."""
    rec = golden["proofs"]["lookup_shuffle"]
    empty, _, _, _ = gen.args_circuit("lookup_shuffle")
    params = JParams.unsafe_setup(rec["k"], seed=rec["params_seed"])
    vk, pk = j_keygen(params, empty)
    return {"params": params, "vk": vk, "pk": pk}


@pytest.mark.parametrize("name", CIRCUITS)
def test_pinned_vk_equal(golden, port, name):
    assert port[name]["vk"].pinned() == golden["proofs"][name]["pinned_vk"]


@pytest.mark.parametrize("name", CIRCUITS)
def test_proof_bytes_equal(golden, port, name):
    assert port.proof(name).hex() == golden["proofs"][name]["proof_hex"]


@pytest.mark.parametrize("name", CIRCUITS)
def test_port_verifier_accepts_the_jax_proof(golden, port, name):
    rec = golden["proofs"][name]
    side = port[name]
    assert verify_proof(side["params"].verifier(1), side["vk"],
                        rec["instances"], bytes.fromhex(rec["proof_hex"]))


def test_jax_verifier_accepts_the_port_proof(jax_side, port):
    assert j_verify_proof(jax_side["params"].verifier(1), jax_side["vk"], [],
                          port.proof("lookup_shuffle"))


def test_carried_key_proves_the_same_bytes(jax_side, golden):
    """The JAX SRS and proving key of a circuit with a lookup and a shuffle,
    carried across by halo2_tpu_torch.convert: the same proof bytes (the
    arguments add no state to the proving key)."""
    rec = golden["proofs"]["lookup_shuffle"]
    k = rec["k"]
    jp, jvk, jpk = jax_side["params"], jax_side["vk"], jax_side["pk"]
    params = convert.params_from_numpy(
        k, np.asarray(jp.g), np.asarray(jp.g_lagrange),
        (jp.s_g2[0].coeffs, jp.s_g2[1].coeffs), device="cpu")
    cs, config, degree = rebuild_cs(LookupShuffleCircuit(), 1 << k)
    vk, pk = convert.proving_key_from_numpy(
        cs, degree, k,
        fixed_lagrange=np.asarray(jpk.fixed_lagrange),
        fixed_coeff=np.asarray(jpk.fixed_coeff),
        sigmas_lagrange=np.asarray(jpk.permutation_pk.sigmas_lagrange),
        sigmas_coeff=np.asarray(jpk.permutation_pk.sigmas_coeff),
        l0_coeff=np.asarray(jpk.l0_coeff),
        l_last_coeff=np.asarray(jpk.l_last_coeff),
        l_blind_coeff=np.asarray(jpk.l_blind_coeff),
        fixed_commitments=jvk.fixed_commitments,
        permutation_commitments=jvk.permutation.commitments,
        config=config, device="cpu")
    assert vk.pinned() == rec["pinned_vk"]
    proof = create_proof(params, pk, LookupShuffleCircuit(
        LookupShuffleCircuit.VALS_A, LookupShuffleCircuit.VALS_B), [],
        seed=rec["prover_seed"], device="cpu")
    assert proof.hex() == rec["proof_hex"]


def test_golden_file_matches_live_jax(jax_side, golden):
    """tests/data/torch_golden_args.json against the JAX package as it is
    now: LookupShuffleCircuit's record but its proof (the key is the one
    the tests above share), and the module vectors of logup_prover and
    shuffle_prover."""
    name = "lookup_shuffle"
    _, _, instances, _ = gen.args_circuit(name)
    want = gen.args_proof_record(name, jax_side["vk"], instances, b"")
    rec = dict(golden["proofs"][name], proof_hex="")
    assert rec == want
    assert golden["logup"] == gen.logup_golden()
    assert golden["shuffle"] == gen.shuffle_golden()


@SLOW
def test_golden_proof_matches_live_jax(jax_side, golden):
    """LookupShuffleCircuit's golden proof bytes against a live JAX proof
    with the golden seed (minutes of XLA compiles on the CPU, hence slow;
    chip_smoke.py's golden phase holds the port's card proofs to the same
    bytes)."""
    name = "lookup_shuffle"
    _, full, instances, _ = gen.args_circuit(name)
    proof = j_create_proof(jax_side["params"], jax_side["pk"], full,
                           instances, seed=gen.ARGS_CIRCUITS[name][3])
    assert golden["proofs"][name]["proof_hex"] == proof.hex()


@pytest.fixture(scope="module")
def plonk_api():
    """tests/test_plonk_api.py's circuit (a lookup, gates, copies, an
    instance) keyed by the port."""
    params = Params.unsafe_setup(5, seed=42, device="cpu")
    vk, pk = keygen(params, PlonkApiCircuit(None, LOOKUP_TABLE),
                    device="cpu")
    return {"params": params, "vk": vk, "pk": pk}


def test_plonk_api_pinned_vk_sha256(golden, plonk_api):
    digest = hashlib.sha256(plonk_api["vk"].pinned().encode()).hexdigest()
    assert digest == golden["plonk_api_pinned_vk_sha256"]


def test_wrong_instance_rejected(plonk_api):
    """One GWC proof of one instance: accepted with it, rejected with
    another."""
    proof = create_proof(plonk_api["params"], plonk_api["pk"],
                         PlonkApiCircuit(A_VALUE, LOOKUP_TABLE), [[INSTANCE]],
                         seed=0, device="cpu")
    pv = plonk_api["params"].verifier(1)
    assert verify_proof(pv, plonk_api["vk"], [[INSTANCE]], proof)
    assert not verify_proof(pv, plonk_api["vk"], [[INSTANCE + 1]], proof)


@SLOW
def test_all_args_wrong_instance_rejected(golden, port):
    side = port["all_args"]
    (a0,), = golden["proofs"]["all_args"]["instances"]
    assert not verify_proof(side["params"].verifier(1), side["vk"],
                            [[(a0 + 1) % 17]], port.proof("all_args"))


def test_shuffle_violation_rejected(port):
    """b in the table, but no longer a permutation of a: the honest prover
    makes a proof, the verifier rejects it."""
    side = port["lookup_shuffle"]
    bad_b = list(LookupShuffleCircuit.VALS_B)
    bad_b[0] = 5
    proof = create_proof(side["params"], side["pk"], LookupShuffleCircuit(
        LookupShuffleCircuit.VALS_A, bad_b), [], seed=3, device="cpu")
    assert not verify_proof(side["params"].verifier(1), side["vk"], [], proof)


def test_missing_lookup_value_raises(port):
    side = port["lookup_shuffle"]
    bad = list(LookupShuffleCircuit.VALS_A)
    bad[2] = 77
    with pytest.raises(ValueError, match="not present in table"):
        create_proof(side["params"], side["pk"], LookupShuffleCircuit(
            bad, LookupShuffleCircuit.VALS_B), [], seed=3, device="cpu")


def test_out_of_range_value_raises(port):
    side = port["range_check"]
    with pytest.raises(ValueError, match="outside"):
        create_proof(side["params"], side["pk"], RangeCheckCircuit([3, 99]),
                     [], seed=4, device="cpu")


def test_lookup_shuffle_proves_under_shplonk(port):
    """tests/test_shplonk.py::test_shplonk_with_lookups_shuffles: the
    port's SHPLONK proof (seed 3) has the JAX package's bytes
    (tests/data/torch_golden_multi.json), and each verifier reading, the
    port's of the JAX proof and of its own, accepts."""
    with open(GOLDEN_MULTI) as fh:
        rec = json.load(fh)["proofs"]["lookup_shuffle_shplonk"]
    side = port["lookup_shuffle"]
    assert side["vk"].pinned() == rec["pinned_vk"]
    proof = create_proof(side["params"], side["pk"], side["circuit"], [],
                         seed=rec["prover_seed"], use_gwc=False, device="cpu")
    assert proof.hex() == rec["proof_hex"]
    assert verify_proof(side["params"].verifier(1), side["vk"], [], proof,
                        use_gwc=False)
