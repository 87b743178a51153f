"""The port's slice as a whole against the JAX package, on the CPU:
Params.unsafe_setup -> keygen -> create_proof -> verify_proof for
tests/test_e2e.py's SimpleCircuit (custom gate, copy constraints, a
constant, a public input), K = 4, Params seed 7, opened with GWC.

Both packages prove from the same seeds.  Tolerance: none — SRS bytes, the
pinned verifying key and the proof bytes are compared for equality, once
with the port's own key and once with the JAX key carried across as numpy
arrays by halo2_tpu_torch.convert.  One module-scoped fixture makes every
JAX call (one keygen, one proof per seed), at the programs
tests/test_e2e.py already compiles.
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
from halo2_tpu.transcript import Blake2bWrite as JBlake2bWrite
from tests.test_e2e import K, SimpleCircuit as JSimpleCircuit, expected_out

from halo2_tpu_torch import convert
from halo2_tpu_torch.circuits import SimpleCircuit
from halo2_tpu_torch.plonk import Circuit
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


def _params_bytes(params) -> bytes:
    buf = io.BytesIO()
    params.write(buf)
    return buf.getvalue()


def _vk_hash(vk, transcript_cls) -> bytes:
    """The transcript state after absorbing the vk, squeezed to bytes."""
    t = transcript_cls()
    vk.hash_into(t)
    return t.squeeze_challenge().to_bytes(32, "little")


@pytest.fixture(scope="module")
def jax_side():
    params = JParams.unsafe_setup(K, seed=PARAMS_SEED)
    vk, pk = j_keygen(params, JSimpleCircuit())
    proofs = {s: j_create_proof(params, pk, JSimpleCircuit(A, B), [[OUT]],
                                seed=s) for s in SEEDS}
    return {"params": params, "vk": vk, "pk": pk, "proofs": proofs}


@pytest.fixture(scope="module")
def port_side():
    params = Params.unsafe_setup(K, seed=PARAMS_SEED, device="cpu")
    vk, pk = keygen(params, SimpleCircuit(), device="cpu")
    proofs = {s: create_proof(params, pk, SimpleCircuit(A, B), [[OUT]],
                              seed=s, device="cpu") for s in SEEDS}
    return {"params": params, "vk": vk, "pk": pk, "proofs": proofs}


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


def test_params_bytes_equal(jax_side, port_side):
    assert _params_bytes(port_side["params"]) == \
        _params_bytes(jax_side["params"])


def test_params_read_round_trip(port_side):
    blob = _params_bytes(port_side["params"])
    again = Params.read(io.BytesIO(blob), device="cpu")
    assert _params_bytes(again) == blob
    assert torch.equal(again.g, port_side["params"].g)


def test_pinned_vk_and_transcript_hash_equal(jax_side, port_side):
    assert port_side["vk"].pinned() == jax_side["vk"].pinned()
    assert _vk_hash(port_side["vk"], Blake2bWrite) == \
        _vk_hash(jax_side["vk"], JBlake2bWrite)


@pytest.mark.parametrize("seed", SEEDS)
def test_proof_bytes_equal_with_own_key(jax_side, port_side, seed):
    assert port_side["proofs"][seed] == jax_side["proofs"][seed]


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


def test_proof_bytes_equal_with_carried_key(jax_side, carried):
    """One seed: the carried state is shown equal to the port's own word
    for word above, and every further proof costs this file its time."""
    seed = SEEDS[1]
    proof = create_proof(carried["params"], carried["pk"],
                         SimpleCircuit(A, B), [[OUT]], seed=seed,
                         device="cpu")
    assert proof == jax_side["proofs"][seed]


def test_each_verifier_accepts_the_others_proof(jax_side, port_side):
    pv = port_side["params"].verifier(1)
    assert verify_proof(pv, port_side["vk"], [[OUT]], jax_side["proofs"][0])
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


def test_golden_file_matches_live_jax_proofs(jax_side):
    """tests/data/torch_golden_proof.json (what chip_smoke.py reproduces on
    the card) against the JAX package as it is now."""
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    assert (golden["k"], golden["params_seed"], golden["a"], golden["b"]) \
        == (K, PARAMS_SEED, A, B)
    assert golden["proofs"] == {str(s): jax_side["proofs"][s].hex()
                                for s in SEEDS}


class _LookupCircuit(Circuit):
    """One advice column looked up in one fixed table column."""

    def without_witnesses(self):
        return _LookupCircuit()

    def configure(self, meta):
        a = meta.advice_column()
        t = meta.fixed_column()
        meta.lookup_any("in_table", lambda m: [(m.query_advice(a, 0),
                                                m.query_fixed(t, 0))])
        return a, t

    def synthesize(self, config, layouter):
        pass


def test_lookup_circuit_is_refused_by_name(port_side):
    with pytest.raises(NotImplementedError, match="lookup"):
        keygen(port_side["params"], _LookupCircuit(), device="cpu")


def test_shplonk_is_refused_by_name(port_side):
    with pytest.raises(NotImplementedError, match="SHPLONK"):
        create_proof(port_side["params"], port_side["pk"],
                     SimpleCircuit(A, B), [[OUT]], seed=0, use_gwc=False,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="SHPLONK"):
        verify_proof(port_side["params"].verifier(1), port_side["vk"],
                     [[OUT]], port_side["proofs"][0], use_gwc=False)


def test_device_mismatch_and_bad_instances_raise(port_side):
    from halo2_tpu_torch.plonk.error import InvalidInstancesError
    with pytest.raises(InvalidInstancesError):
        create_proof(port_side["params"], port_side["pk"],
                     SimpleCircuit(A, B), [], seed=0, device="cpu")
    with pytest.raises(ValueError):
        verify_proof(port_side["params"].verifier(1), port_side["vk"], [],
                     port_side["proofs"][0])
