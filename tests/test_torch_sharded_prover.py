"""The port's prover over a mesh of 8 "cpu" shards (params.use_mesh: the
sharded commitment MSMs, the four-step step-7 iNTTs, the row-sharded h
evaluator with its distributed coset extensions and rolls, the extended
iNTT of the quotient over the mesh) against the single-device prover, as
tests/test_sharded_prover.py and tests/test_sharded_all_args.py hold the
JAX package's:

  * SimpleCircuit at K = 6 (params seed 7, prover seed 0): the sharded
    proof byte for byte equal to the JAX package's sharded proof
    (tests/data/torch_golden_mesh.json; when it was written,
    gen_torch_golden.py held it equal to the JAX package's unsharded proof
    and the JAX verifier accepted it), and accepted by the port's
    verifier;
  * the sharded evaluator equal limb for limb, after gathering, to the
    single-device Evaluator on random inputs, and to the JAX package's
    sharded evaluator (sha256 of h);
  * LookupShuffleCircuit at K = 6 (a logup over two chained input sets,
    m(X), a shuffle): the sharded proof equal to the JAX package's
    unsharded proof of the golden record;
  * `slow`: AllArgsCircuit (range check too) at K = 9 against
    tests/data/torch_golden_args.json, the degree-5 gate at K = 10 (ext_k
    12, no gate lowered) and MulChainCircuit at K = 12, whose commitments
    pass MESH_MSM_MIN without lowering it; each also equal to the port's
    own unsharded proof (the last two have no JAX golden).

The smaller cases lower Params.MESH_MSM_MIN to 1 with monkeypatch, as the
JAX tests do, so that every commitment and iNTT takes the mesh path.
Tolerance: none.
"""

import json
import os
import random

import pytest
import torch

from halo2_tpu_torch.circuit import FlatFloorPlanner
from halo2_tpu_torch.circuits import (AllArgsCircuit, LookupShuffleCircuit,
                                      MulChainCircuit, SimpleCircuit)
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P, fr
from halo2_tpu_torch.plonk import Circuit
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.utils import profiling
from halo2_tpu_torch.utils.mesh import Mesh
from tests.data.gen_torch_golden import ints_sha256, mesh_ev_inputs

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
A, B = 3, 5


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(DATA, "torch_golden_mesh.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def mesh(golden):
    return Mesh(["cpu"] * golden["devices"])


@pytest.fixture(scope="module")
def simple(golden):
    rec = golden["simple_k6"]
    params = Params.unsafe_setup(rec["k"], seed=rec["params_seed"],
                                 device="cpu")
    vk, pk = keygen(params, SimpleCircuit(), device="cpu")
    return rec, params, vk, pk


def _prove_sharded(params, pk, circuit, instances, seed, mesh, monkeypatch,
                   floor_planner=None, lower_gate=True):
    """(sharded proof, the sharded run's counters)."""
    if lower_gate:
        monkeypatch.setattr(Params, "MESH_MSM_MIN", 1)
    profiling.reset()
    params.use_mesh(mesh)
    try:
        sharded = create_proof(params, pk, circuit, instances, seed=seed,
                               floor_planner=floor_planner, device="cpu")
    finally:
        params.use_mesh(None)
    return sharded, dict(profiling.counters)


def _prove_both(params, pk, circuit, instances, seed, mesh, monkeypatch,
                floor_planner=None, lower_gate=True):
    """(unsharded proof, sharded proof, the sharded run's counters): for
    the cases with no JAX sharded golden, where the port's own unsharded
    proof is the reference."""
    single = create_proof(params, pk, circuit, instances, seed=seed,
                          floor_planner=floor_planner, device="cpu")
    return (single,) + _prove_sharded(params, pk, circuit, instances, seed,
                                      mesh, monkeypatch, floor_planner,
                                      lower_gate)


def test_sharded_proof_matches_single_device(simple, mesh, monkeypatch):
    rec, params, vk, pk = simple
    out = SimpleCircuit.expected_out(A, B)
    assert rec["instances"] == [[out]]
    sharded, counters = _prove_sharded(
        params, pk, SimpleCircuit(A, B), [[out]], rec["prover_seed"], mesh,
        monkeypatch)
    assert vk.pinned() == rec["pinned_vk"]
    # the JAX package's sharded proof, which equalled its unsharded one
    # when the golden was written (gen_torch_golden.py asserts it)
    assert sharded.hex() == rec["proof_hex"]
    assert verify_proof(params.verifier(1), vk, [[out]], sharded)
    # the transforms went over the mesh: the step-7 stacks, every
    # extension of the evaluator, the quotient's inverse
    assert counters["dist_ntt_calls"] >= 8


def test_use_mesh_rejects_a_mesh_elsewhere(simple):
    _, params, _, _ = simple
    with pytest.raises(ValueError):
        params.use_mesh(Mesh(["cuda:0"] * 2))
    assert params.mesh is None


def test_sharded_evaluator_matches_single(simple, mesh, golden):
    """The two h-evaluators on random inputs, limb for limb."""
    _, params, vk, pk = simple
    rec = golden["evaluate_h"]
    F = fr("cpu")
    n = 1 << rec["k"]
    inputs = mesh_ev_inputs(vk.cs, n)

    def stack(cols):
        return (torch.stack([F.encode(c) for c in cols], dim=1) if cols
                else F.zeros((0, n)))
    empty = stack([])
    args = (stack(inputs["advice"]), stack(inputs["instance"]),
            stack(inputs["perm_z"]), empty, empty, empty,
            *rec["challenges"])
    single = pk.ev.evaluate_h(*args)
    sharded = pk.sharded_ev(mesh).evaluate_h(*args)
    assert [tuple(s.shape) for s in sharded.shards] == \
        [(16, vk.domain.extended_n // 8)] * 8
    whole = sharded.gather()
    assert torch.equal(whole, single)
    assert ints_sha256(F.decode(whole)) == rec["h_sha256"]
    # chained across proofs: value_init is a previous sharded result
    again = pk.sharded_ev(mesh).evaluate_h(*args, value_init=sharded)
    assert torch.equal(again.gather(),
                       pk.ev.evaluate_h(*args, value_init=single))


def test_sharded_proof_lookup_shuffle(golden, mesh, monkeypatch):
    """A shared-table logup with two chunked input sets (z chaining through
    the last-rotation roll), m(X) and a shuffle product over the mesh."""
    rec = golden["lookup_shuffle_k6"]
    params = Params.unsafe_setup(rec["k"], seed=rec["params_seed"],
                                 device="cpu")
    vk, pk = keygen(params, LookupShuffleCircuit(), device="cpu")
    assert vk.pinned() == rec["pinned_vk"]
    circuit = LookupShuffleCircuit(LookupShuffleCircuit.VALS_A,
                                   LookupShuffleCircuit.VALS_B)
    sharded, _ = _prove_sharded(params, pk, circuit, [], rec["prover_seed"],
                                mesh, monkeypatch)
    assert sharded.hex() == rec["proof_hex"]
    assert verify_proof(params.verifier(1), vk, [], sharded)


@pytest.mark.slow
def test_sharded_proof_all_args(mesh, monkeypatch):
    """Every argument, the range check included, against the JAX package's
    unsharded AllArgsCircuit proof (K = 9)."""
    with open(os.path.join(DATA, "torch_golden_args.json")) as fh:
        rec = json.load(fh)["proofs"]["all_args"]
    k = rec["k"]
    params = Params.unsafe_setup(k, seed=rec["params_seed"], device="cpu")
    circuit = AllArgsCircuit(AllArgsCircuit.usable_rows(k))
    vk, pk = keygen(params, circuit, floor_planner=FlatFloorPlanner,
                    device="cpu")
    single, sharded, _ = _prove_both(
        params, pk, circuit, rec["instances"], rec["prover_seed"], mesh,
        monkeypatch, floor_planner=FlatFloorPlanner)
    assert sharded == single
    assert sharded.hex() == rec["proof_hex"]
    assert verify_proof(params.verifier(1), vk, rec["instances"], sharded)


class Deg5Circuit(Circuit):
    """tests/test_sharded_deg5.py's row-filling degree-5 gate
    s * (a*b*c*d - e): quotient degree 4, so ext_k = k + 2."""

    def __init__(self, rows=None, seed=2):
        self.rows = rows
        self.seed = seed

    def without_witnesses(self):
        return Deg5Circuit(self.rows, self.seed)

    def configure(self, meta):
        cols = [meta.advice_column() for _ in range(5)]
        s = meta.selector()

        def gate(m):
            a, b, c, d, e = (m.query_advice(col, 0) for col in cols)
            return [("deg5", m.query_selector(s) * (a * b * c * d - e))]

        meta.create_gate("deg5", gate)
        return cols, s

    def synthesize(self, config, layouter):
        cols, s = config
        rng = random.Random(self.seed)
        rows = self.rows
        vals = [[rng.randrange(1, P) for _ in range(rows)] for _ in range(4)]
        outs = [vals[0][i] * vals[1][i] % P * vals[2][i] % P * vals[3][i] % P
                for i in range(rows)]

        def fn(region):
            for i in range(rows):
                region.enable_selector("s", s, i)
            for c, v in zip(cols, vals + [outs]):
                region.assign_advice_bulk("col", c, 0, v)
        layouter.assign_region("deg5", fn)


@pytest.mark.slow
def test_sharded_proof_deg5_k10(mesh, monkeypatch):
    """ext_k = 12 over 8 shards: multi-row all_to_all tiles (a 64 x 64
    four-step split), a degree-4 quotient; the gate left as it is, so at
    n = 2^10 only the evaluator takes the mesh."""
    k = 10
    params = Params.unsafe_setup(k, seed=13, device="cpu")
    from halo2_tpu_torch.plonk.circuit import ConstraintSystem
    probe = ConstraintSystem()
    Deg5Circuit(1).configure(probe)
    circuit = Deg5Circuit(probe.usable_rows(1 << k))
    vk, pk = keygen(params, circuit, device="cpu")
    single, sharded, _ = _prove_both(params, pk, circuit, [], 0, mesh,
                                     monkeypatch, lower_gate=False)
    assert sharded == single
    assert verify_proof(params.verifier(1), vk, [], sharded)


@pytest.mark.slow
def test_sharded_proof_natural_gate(mesh, monkeypatch):
    """MulChainCircuit at K = 12: the commitments (n = 2^12) pass
    MESH_MSM_MIN as it stands, and the four-step splits are multi-row."""
    k = 12
    assert 1 << k >= Params.MESH_MSM_MIN
    params = Params.unsafe_setup(k, seed=11, device="cpu")
    circuit = MulChainCircuit(MulChainCircuit.steps_for(k), a=3, b=5)
    vk, pk = keygen(params, circuit, device="cpu")
    inst = [[circuit.expected_out()]]
    single, sharded, counters = _prove_both(params, pk, circuit, inst, 0,
                                            mesh, monkeypatch,
                                            lower_gate=False)
    assert sharded == single
    assert verify_proof(params.verifier(1), vk, inst, sharded)
    assert counters["dist_ntt_calls"] >= 8
