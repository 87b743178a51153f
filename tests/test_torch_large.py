"""The port's large-domain paths (large k on one card) on the CPU, at small
sizes: the streamed extended inverse transform, the twiddle tables dropped
and rebuilt, extended_to_coeff's streamed path, the Lagrange offloads of
Params and ProvingKey, and the prover's large-domain sequence forced at
K = 4 and 5 by lowering its thresholds (LARGE_N, STREAM_NTT_MIN).

Tolerance: none — limb words, decoded integers, commitments and proof
bytes are compared for equality.  The proof bytes are the JAX package's,
from tests/data/torch_golden_proof.json and torch_golden_args.json; one
streamed transform is held against the live JAX inverse_streamed_nodiv on
the same numpy input.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.fields.bn254 import Fr as JFr
from halo2_tpu.ntt.ntt import NTT as JNTT

from halo2_tpu_torch.circuits import SimpleCircuit
from halo2_tpu_torch.fields import limbs as tl
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.ntt.ntt import NTT, powers_table_np
from halo2_tpu_torch.plonk import prover
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly import domain as domain_mod
from halo2_tpu_torch.poly.arith import PointPowers
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.poly.domain import EvaluationDomain, Polynomial
from halo2_tpu_torch.utils import offload, profiling
from tests.data.torch_golden_circuits import argument_circuit

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PARAMS_SEED = 7
A, B = 3, 5
OUT = SimpleCircuit.expected_out(A, B)
JAX_LOG_N = 8


def _rand_ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(DATA, "torch_golden_proof.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def simple_keys():
    params = Params.unsafe_setup(4, seed=PARAMS_SEED, device="cpu")
    vk, pk = keygen(params, SimpleCircuit(), device="cpu")
    return params, vk, pk


@pytest.fixture
def forced(monkeypatch):
    """The large-domain sequence at every size."""
    monkeypatch.setattr(prover, "LARGE_N", 1)
    monkeypatch.setattr(domain_mod, "STREAM_NTT_MIN", 1)


@pytest.mark.parametrize("chunks_log", range(4))
@pytest.mark.parametrize("log_n", range(2, 11))
def test_streamed_inverse_equals_inverse_nodiv(log_n, chunks_log):
    F = fr("cpu")
    ntt = NTT(log_n, "cpu")
    a = F.encode(_rand_ints(log_n * 10 + chunks_log, 1 << log_n))
    want = ntt.inverse_nodiv(a)
    profiling.reset()
    box = [a.clone()]
    got = ntt.inverse_streamed_nodiv(box, chunks_log=chunks_log)
    assert box == []                         # the input was taken over
    assert torch.equal(got, want)
    assert profiling.counters["ntt_streamed_calls"] == 1
    # a tensor (not handed over) stays the caller's, unchanged
    kept = a.clone()
    assert torch.equal(ntt.inverse_streamed_nodiv(kept, chunks_log), want)
    assert torch.equal(kept, a)


def test_streamed_inverse_equals_the_live_jax_one():
    vals = _rand_ints(JAX_LOG_N, 1 << JAX_LOG_N)
    jax_out = np.asarray(JNTT(JAX_LOG_N).inverse_streamed_nodiv(
        jnp.asarray(JFr.encode(vals))))
    F = fr("cpu")
    got = NTT(JAX_LOG_N, "cpu").inverse_streamed_nodiv([F.encode(vals)])
    assert np.array_equal(tl.to_numpy(got), jax_out)


@pytest.mark.parametrize("log_n", (0, 1, 5, 9))
def test_tables_rebuilt_after_a_drop_are_the_host_tables(log_n):
    """The device-built tables hold powers_table_np's words (the host build
    they replace), and a transform after drop_tables rebuilds them."""
    F = fr("cpu")
    ntt = NTT(log_n, "cpu")
    a = F.encode(_rand_ints(300 + log_n, 1 << log_n))
    fwd, inv = ntt.forward(a), ntt.inverse(a)
    for inverse in (False, True):
        w = ntt.omega_inv if inverse else ntt.omega
        full = powers_table_np(w, ntt.n, P, F.to_mont_int)
        i1 = np.arange(ntt.n1)
        k2 = np.arange(ntt.n2)
        mid = full[:, ((k2[:, None] * i1[None, :]) % ntt.n).reshape(-1)]
        assert np.array_equal(tl.to_numpy(ntt._tables(inverse)["mid"]), mid)
    ntt.drop_tables(inverse=False)
    assert list(ntt._tables_cache) == [True]
    ntt.drop_tables()
    assert ntt._tables_cache == {}
    assert torch.equal(ntt.forward(a), fwd)
    assert torch.equal(ntt.inverse(a), inv)
    assert F.decode(ntt.inverse([fwd.clone()])) == F.decode(a)


@pytest.mark.parametrize("degree", (3, 4))
def test_extended_to_coeff_streamed_equals_direct(monkeypatch, degree):
    """Mirrors tests/test_domain.py's streamed case: STREAM_NTT_MIN forced
    to 1, the same quotient coefficients; the extended values are
    consumed either way."""
    dom = EvaluationDomain(degree, 4, "cpu")
    coeffs = dom.coeff_from_ints(_rand_ints(40 + degree, dom.n))
    ext = dom.coeff_to_extended(coeffs).values
    p = Polynomial(ext.clone(), "extended")
    direct = dom.extended_to_coeff(p)
    assert p.values is None
    monkeypatch.setattr(domain_mod, "STREAM_NTT_MIN", 1)
    profiling.reset()
    p = Polynomial(ext.clone(), "extended")
    streamed = dom.extended_to_coeff(p)
    assert p.values is None
    assert profiling.counters["ntt_streamed_calls"] == 1
    assert torch.equal(direct, streamed)
    assert dom.F.decode(streamed)[:dom.n] == dom.F.decode(coeffs.values)


def test_host_copy_states():
    """The offload's state machine on the CPU: a copy into another tensor,
    the device tensors held until join."""
    t = fr("cpu").encode(_rand_ints(5, 16))
    copy = offload.HostCopy([t, t[:, :3]])
    assert copy._device_tensors[0] is t
    host, part = copy.join()
    assert copy._device_tensors is None
    assert host is not t and torch.equal(host, t)
    assert torch.equal(part, t[:, :3])
    assert offload.onload(host, torch.device("cpu")) is host


def test_params_offload_round_trip(simple_keys):
    params, _, _ = simple_keys
    col = fr("cpu").encode(_rand_ints(7, params.n))
    before = params.commit_many_affine([col], base="lagrange")
    device_copy = params.g_lagrange
    profiling.reset()
    params.offload_lagrange()
    params.offload_lagrange()                # in flight: no second copy
    assert profiling.counters["lagrange_offloads"] == 1
    params.join_offload()
    assert params._lagrange_on_host
    assert params._g_lagrange is not device_copy
    assert torch.equal(params._g_lagrange, device_copy)
    # every reader brings it back: commit, verifier, write
    assert params.commit_many_affine([col], base="lagrange") == before
    assert not params._lagrange_on_host
    params.offload_lagrange()
    assert params.verifier(1).g_lagrange
    params.offload_lagrange()
    params.join_offload()
    assert torch.equal(params.g_lagrange, device_copy)


def test_proving_key_offload_round_trip(simple_keys, golden):
    params, vk, pk = simple_keys
    fixed, sigmas = pk.fixed_lagrange, pk.permutation_pk.sigmas_lagrange
    profiling.reset()
    pk.offload_lagrange_forms()
    pk.join_offloads()
    assert profiling.counters["lagrange_offloads"] == 1
    assert pk._forms_on_host and pk.fixed_lagrange is not fixed
    pk.onload_lagrange_forms()
    assert not pk._forms_on_host
    assert torch.equal(pk.fixed_lagrange, fixed)
    assert torch.equal(pk.permutation_pk.sigmas_lagrange, sigmas)
    # offloaded and not brought back by hand: the prover does
    pk.offload_lagrange_forms()
    proof = prover.create_proof(params, pk, SimpleCircuit(A, B), [[OUT]],
                                seed=0, device="cpu")
    assert proof.hex() == golden["proofs"]["0"]


def test_golden_proofs_under_forced_thresholds(simple_keys, golden, forced):
    """Seeds 0 and 1 in one process with offload_lagrange and the
    large-domain sequence at K = 4: the JAX package's bytes both times,
    the second proof warm after the first one's offloads and drops."""
    params, vk, pk = simple_keys
    domain = vk.domain
    for seed in (0, 1):
        profiling.reset()
        proof = prover.create_proof(params, pk, SimpleCircuit(A, B),
                                    [[OUT]], seed=seed, device="cpu",
                                    offload_lagrange=True)
        assert proof.hex() == golden["proofs"][str(seed)]
        assert profiling.counters["ntt_streamed_calls"] >= 1
        assert profiling.counters["lagrange_offloads"] == 2
        # what the proof let go: the key's forms and the SRS's Lagrange
        # basis on the host, no extended tables, no challenge tables
        assert pk._forms_on_host and params._lagrange_on_host
        assert domain.ntt_ext._tables_cache == {}
        assert PointPowers._cache == {}
        assert verify_proof(params.verifier(1), vk, [[OUT]], proof)


def test_argument_proof_under_forced_thresholds(forced):
    """LookupShuffleCircuit (K = 5) proved twice in one process with the
    large-domain sequence: the golden bytes both times."""
    with open(os.path.join(DATA, "torch_golden_args.json")) as fh:
        rec = json.load(fh)["proofs"]["lookup_shuffle"]
    circuit, planner = argument_circuit("lookup_shuffle", rec["k"])
    params = Params.unsafe_setup(rec["k"], seed=rec["params_seed"],
                                 device="cpu")
    vk, pk = keygen(params, circuit, floor_planner=planner, device="cpu")
    for _ in range(2):
        proof = prover.create_proof(params, pk, circuit, rec["instances"],
                                    seed=rec["prover_seed"],
                                    floor_planner=planner, device="cpu",
                                    offload_lagrange=True)
        assert proof.hex() == rec["proof_hex"]
        assert verify_proof(params.verifier(1), vk, rec["instances"], proof)
