"""The port's slice as a whole against the JAX package, on the CPU:
Params.unsafe_setup -> keygen -> create_proof -> verify_proof for
tests/test_e2e.py's SimpleCircuit (custom gate, copy constraints, a
constant, a public input), K = 4, Params seed 7, opened with GWC; and
under SHPLONK, that circuit and a lookup_any circuit against the SHPLONK
proofs of tests/data/torch_golden_multi.json.

Both packages prove from the same seeds.  Tolerance: none — SRS bytes, the
pinned verifying key and the proof bytes are compared for equality, once
with the port's own key and once with the JAX key carried across as numpy
arrays by halo2_tpu_torch.convert.

The JAX package's bytes come from tests/data/torch_golden_proof.json
(written by tests/data/gen_torch_golden.py), which one test holds against
the live JAX package.  Live JAX objects are made only where a test needs
them (the carried key, the JAX verifier, that check): the module-scoped
`jax_side` fixture makes the JAX keygen, and the JAX proofs are made once,
in the golden check; so a test worker that runs none of those tests makes
no JAX call.  The port's proofs are made at first use, per seed.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from halo2_tpu.plonk.keygen import keygen as j_keygen
from halo2_tpu.plonk.prover import create_proof as j_create_proof
from halo2_tpu.plonk.verifier import verify_proof as j_verify_proof
from halo2_tpu.poly.commitment import Params as JParams
from tests.data.gen_torch_golden import golden_of, params_bytes, vk_hash
from tests.test_e2e import K, SimpleCircuit as JSimpleCircuit, expected_out

from halo2_tpu_torch import convert
from halo2_tpu_torch.circuits import LookupAnyCircuit, SimpleCircuit
from halo2_tpu_torch.plonk.keygen import keygen, rebuild_cs
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.transcript import Blake2bWrite

torch.set_num_threads(1)

PARAMS_SEED = 7
A, B = 3, 5
OUT = expected_out(A, B)
SEEDS = (0, 1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_proof.json")
GOLDEN_MULTI = os.path.join(os.path.dirname(GOLDEN), "torch_golden_multi.json")


class _Proofs(dict):
    """The port's proofs with one key, each made at its first use."""

    def __init__(self, params, pk):
        super().__init__()
        self._params, self._pk = params, pk

    def __missing__(self, seed):
        proof = self[seed] = create_proof(
            self._params, self._pk, SimpleCircuit(A, B), [[OUT]], seed=seed,
            device="cpu")
        return proof


@pytest.fixture(scope="module")
def golden():
    """The JAX package's bytes for this circuit and these seeds."""
    with open(GOLDEN) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def jax_side():
    params = JParams.unsafe_setup(K, seed=PARAMS_SEED)
    vk, pk = j_keygen(params, JSimpleCircuit())
    return {"params": params, "vk": vk, "pk": pk}


@pytest.fixture(scope="module")
def port_side():
    params = Params.unsafe_setup(K, seed=PARAMS_SEED, device="cpu")
    vk, pk = keygen(params, SimpleCircuit(), device="cpu")
    return {"params": params, "vk": vk, "pk": pk,
            "proofs": _Proofs(params, pk)}


@pytest.fixture(scope="module")
def carried(jax_side):
    """The JAX SRS and proving key, carried across as numpy arrays."""
    jp, jvk, jpk = jax_side["params"], jax_side["vk"], jax_side["pk"]
    params = convert.params_from_numpy(
        K, np.asarray(jp.g), np.asarray(jp.g_lagrange),
        (jp.s_g2[0].coeffs, jp.s_g2[1].coeffs), device="cpu")
    cs, config, degree = rebuild_cs(SimpleCircuit(), 1 << K)
    vk, pk = convert.proving_key_from_numpy(
        cs, degree, K,
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
    return {"params": params, "vk": vk, "pk": pk}


def test_params_bytes_equal(golden, port_side):
    assert params_bytes(port_side["params"]).hex() == golden["params_hex"]


def test_params_read_round_trip(port_side):
    blob = params_bytes(port_side["params"])
    again = Params.read(io.BytesIO(blob), device="cpu")
    assert params_bytes(again) == blob
    assert torch.equal(again.g, port_side["params"].g)


def test_pinned_vk_and_transcript_hash_equal(golden, port_side):
    assert port_side["vk"].pinned() == golden["pinned_vk"]
    assert vk_hash(port_side["vk"], Blake2bWrite).hex() == \
        golden["vk_hash_hex"]


@pytest.mark.parametrize("seed", SEEDS)
def test_proof_bytes_equal_with_own_key(golden, port_side, seed):
    assert port_side["proofs"][seed].hex() == golden["proofs"][str(seed)]


def test_proofs_differ_between_seeds(port_side):
    assert port_side["proofs"][0] != port_side["proofs"][1]


def test_carried_key_state_equals_own_key(port_side, carried):
    pk, own = carried["pk"], port_side["pk"]
    assert torch.equal(carried["params"].g_lagrange,
                       port_side["params"].g_lagrange)
    for name in ("fixed_lagrange", "fixed_coeff", "l0_coeff", "l_last_coeff",
                 "l_blind_coeff"):
        assert torch.equal(getattr(pk, name), getattr(own, name)), name
    assert torch.equal(pk.permutation_pk.sigmas_coeff,
                       own.permutation_pk.sigmas_coeff)
    assert carried["vk"].pinned() == port_side["vk"].pinned()


def test_proof_bytes_equal_with_carried_key(golden, carried):
    """One seed: the carried state is shown equal to the port's own word
    for word above, and every further proof costs this file its time."""
    seed = SEEDS[1]
    proof = create_proof(carried["params"], carried["pk"],
                         SimpleCircuit(A, B), [[OUT]], seed=seed,
                         device="cpu")
    assert proof.hex() == golden["proofs"][str(seed)]


def test_each_verifier_accepts_the_others_proof(jax_side, golden, port_side):
    pv = port_side["params"].verifier(1)
    jax_proof = bytes.fromhex(golden["proofs"][str(SEEDS[0])])
    assert verify_proof(pv, port_side["vk"], [[OUT]], jax_proof)
    jpv = jax_side["params"].verifier(1)
    assert j_verify_proof(jpv, jax_side["vk"], [[OUT]],
                          port_side["proofs"][1])


def test_wrong_instance_rejected(port_side):
    pv = port_side["params"].verifier(1)
    assert not verify_proof(pv, port_side["vk"], [[OUT + 1]],
                            port_side["proofs"][0])


def test_tampered_proof_rejected(port_side):
    pv = port_side["params"].verifier(1)
    proof = bytearray(port_side["proofs"][0])
    proof[-40] ^= 1
    try:
        ok = verify_proof(pv, port_side["vk"], [[OUT]], bytes(proof))
    except ValueError:
        ok = False
    assert not ok


def test_golden_file_matches_live_jax_proofs(jax_side, golden):
    """tests/data/torch_golden_proof.json (what the tests above and
    chip_smoke.py on the card hold the port to) against the JAX package as
    it is now: SRS bytes, pinned vk, vk hash and one proof per seed."""
    assert (golden["k"], golden["params_seed"], golden["a"], golden["b"]) \
        == (K, PARAMS_SEED, A, B)
    jp, jpk = jax_side["params"], jax_side["pk"]
    proofs = {s: j_create_proof(jp, jpk, JSimpleCircuit(A, B), [[OUT]],
                                seed=s) for s in SEEDS}
    assert golden == golden_of(jp, jax_side["vk"], proofs)


@pytest.fixture(scope="module")
def golden_multi():
    """The JAX package's SHPLONK proofs
    (tests/data/torch_golden_multi.json)."""
    with open(GOLDEN_MULTI) as fh:
        return json.load(fh)["proofs"]


def test_lookup_circuit_proves_under_shplonk(port_side, golden_multi):
    """A circuit with a lookup (one advice column in one fixed column)
    keygens with its lookup in the constraint system, and its SHPLONK proof
    (seed 0) has the JAX package's bytes and is accepted."""
    rec = golden_multi["lookup_any_shplonk"]
    vk, pk = keygen(port_side["params"], LookupAnyCircuit(), device="cpu")
    assert len(vk.cs.lookups) == 1
    assert "(lookup0," in vk.pinned()
    assert vk.pinned() == rec["pinned_vk"]
    proof = create_proof(port_side["params"], pk,
                         LookupAnyCircuit(LookupAnyCircuit.VALUES), [],
                         seed=rec["prover_seed"], use_gwc=False,
                         device="cpu")
    assert proof.hex() == rec["proof_hex"]
    assert verify_proof(port_side["params"].verifier(1), vk, [], proof,
                        use_gwc=False)


def test_shplonk_proof_bytes_equal_and_verify(port_side, golden_multi):
    """tests/test_shplonk.py's SimpleCircuit proof under SHPLONK (seed 0):
    the JAX package's bytes, accepted with its instance and rejected with
    another."""
    rec = golden_multi["simple_shplonk"]
    proof = create_proof(port_side["params"], port_side["pk"],
                         SimpleCircuit(A, B), [[OUT]], seed=rec["prover_seed"],
                         use_gwc=False, device="cpu")
    assert rec["instances"] == [[[OUT]]]
    assert proof.hex() == rec["proof_hex"]
    pv = port_side["params"].verifier(1)
    assert verify_proof(pv, port_side["vk"], [[OUT]], proof, use_gwc=False)
    assert not verify_proof(pv, port_side["vk"], [[OUT + 1]], proof,
                            use_gwc=False)


def test_device_mismatch_and_bad_instances_raise(port_side):
    from halo2_tpu_torch.plonk.error import InvalidInstancesError
    with pytest.raises(InvalidInstancesError):
        create_proof(port_side["params"], port_side["pk"],
                     SimpleCircuit(A, B), [], seed=0, device="cpu")
    with pytest.raises(ValueError):
        verify_proof(port_side["params"].verifier(1), port_side["vk"], [],
                     port_side["proofs"][0])
