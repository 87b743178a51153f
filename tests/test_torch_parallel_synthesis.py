"""Parallel witness synthesis in the port (plonk/parallel_synthesis.py):
forked workers writing region cells into shared-memory columns give the
witness the sequential path gives, and the JAX package's witness (live,
host-only calls of tests/test_parallel_synthesis.py's ParCircuit),
including the overflow merge of values >= 2^64, deferred rationals and
error propagation.  Then BlockMulChainCircuit, the circuit chip_smoke.py's
`synth` phase proves at k = 16, at K = 5: the same proof bytes and witness
file with its regions synthesized in turn and by four workers, equal to
the JAX package's (tests/data/torch_golden_synth.json)."""

import hashlib
import json
import os

import numpy as np
import pytest

from halo2_tpu_torch.circuit import (FlatFloorPlanner, SimpleFloorPlanner,
                                     SingleChipLayouter)
from halo2_tpu_torch.circuits import BlockMulChainCircuit
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P
from halo2_tpu_torch.plonk import parallel_synthesis
from halo2_tpu_torch.plonk.assigned import Assigned
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.error import SynthesisError
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.prover import (WitnessCollection, create_proof,
                                          create_witness, synthesize_witness)
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.utils import profiling
from tests import test_parallel_synthesis as jax_side

N = jax_side.N
ROWS_PER_REGION = jax_side.ROWS_PER_REGION
REGIONS = jax_side.REGIONS
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_synth.json")


class ParConfig:
    def __init__(self, a, b):
        self.a, self.b = a, b


class ParCircuit:
    """tests/test_parallel_synthesis.py's ParCircuit on the port's DSL:
    REGIONS independent regions at absolute offsets (flat planner), per-cell
    writes in column a, a bulk write in column b; region 3 also writes a
    value >= 2^64 (the overflow merge) and a deferred rational."""

    def __init__(self, workers, big=True, fail_region=None,
                 use_constant=False):
        self.workers = workers
        self.big = big
        self.fail_region = fail_region
        self.use_constant = use_constant

    def configure(self, meta):
        return ParConfig(meta.advice_column(), meta.advice_column())

    def synthesize(self, config, layouter):
        def make_region(j):
            def fn(region):
                base = j * ROWS_PER_REGION
                last = None
                for i in range(ROWS_PER_REGION):
                    v = (j * 100003 + i * 7) % P
                    last = region.assign_advice("a", config.a, base + i, v)
                region.assign_advice_bulk(
                    "b", config.b, base,
                    np.arange(ROWS_PER_REGION, dtype=np.uint64) + j)
                if j == 3 and self.big:
                    region.assign_advice("big", config.a, base, P - 1)
                    region.assign_advice("rat", config.b, base,
                                         Assigned(num=6, den=3))
                if j == self.fail_region:
                    raise ValueError("boom in region")
                if j == 2 and self.use_constant:
                    region.assign_advice_from_constant(
                        "c", config.a, base + 1, 5)
                return last
            return fn

        return layouter.assign_regions(
            "par", [make_region(j) for j in range(REGIONS)],
            workers=self.workers)


def synthesize(circuit, flat=True):
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    witness = WitnessCollection(cs, N, cs.usable_rows(N), [])
    layouter = SingleChipLayouter(witness, cs.constants, flat=flat)
    result = circuit.synthesize(config, layouter)
    witness.resolve_deferred()
    return witness, result


def as_int_col(col):
    return [int(v) for v in col]


def _fan_outs(fn):
    before = profiling.counters.get("synth_fan_outs", 0)
    out = fn()
    return out, profiling.counters.get("synth_fan_outs", 0) - before


def test_parallel_matches_sequential_and_the_jax_package():
    (w_seq, _), seq_forks = _fan_outs(lambda: synthesize(ParCircuit(1)))
    (w_par, res_par), par_forks = _fan_outs(lambda: synthesize(ParCircuit(4)))
    assert (seq_forks, par_forks) == (0, 1)
    w_jax, _ = jax_side.synthesize(jax_side.ParCircuit(workers=1))
    for col in range(2):
        assert as_int_col(w_par.advice[col]) == as_int_col(w_seq.advice[col])
        assert as_int_col(w_par.advice[col]) == as_int_col(w_jax.advice[col])
    # the same column kinds: a degraded by P - 1, b still u64
    assert [isinstance(c, np.ndarray) for c in w_par.advice] == \
        [isinstance(c, np.ndarray) for c in w_jax.advice] == [False, True]
    assert w_par.max_assigned == w_seq.max_assigned == w_jax.max_assigned
    assert w_par.max_value == w_seq.max_value == w_jax.max_value
    assert as_int_col(w_par.advice[0])[3 * ROWS_PER_REGION] == P - 1
    assert as_int_col(w_par.advice[1])[3 * ROWS_PER_REGION] == 2
    # region results come back in order (AssignedCells pickle)
    assert len(res_par) == REGIONS
    for j, cell in enumerate(res_par):
        assert cell.cell.row == j * ROWS_PER_REGION + ROWS_PER_REGION - 1


def test_worker_error_propagates():
    with pytest.raises(SynthesisError, match="boom"):
        synthesize(ParCircuit(workers=4, fail_region=5))


def test_constrain_constant_rejected_in_parallel():
    with pytest.raises(SynthesisError, match="constrain_constant"):
        synthesize(ParCircuit(workers=4, use_constant=True))


def test_shared_columns_survive_collection():
    """The advice arrays stay valid after the collection is dropped (the
    columns were copied out of shared memory before the mappings closed)."""
    w, _ = synthesize(ParCircuit(workers=4, big=False))
    cols = w.advice
    del w
    assert int(np.asarray(cols[1][:4]).sum()) >= 0
    assert all(isinstance(c, np.ndarray) and c.base is None for c in cols)


def test_regions_run_in_turn_where_they_cannot_fan_out():
    """Not flat, one worker, or a column already degraded: no fork."""
    class TwoRegions(ParCircuit):
        def synthesize(self, config, layouter):
            return layouter.assign_regions("two", [
                lambda region, v=v: region.assign_advice("a", config.a, 0, v)
                for v in (5, 6)], workers=4)
    (w, cells), forks = _fan_outs(lambda: synthesize(TwoRegions(4),
                                                     flat=False))
    assert forks == 0
    assert [c.cell.row for c in cells] == [0, 1]     # placed in turn
    _, forks = _fan_outs(lambda: synthesize(ParCircuit(1)))
    assert forks == 0
    cs = ConstraintSystem()
    config = ParCircuit(4).configure(cs)
    witness = WitnessCollection(cs, N, cs.usable_rows(N), [])
    witness.assign_advice(config.a, N - 20, P - 1)      # degrades column a
    assert not witness.supports_parallel_regions()
    _, forks = _fan_outs(lambda: ParCircuit(4).synthesize(
        config, SingleChipLayouter(witness, cs.constants, flat=True)))
    assert forks == 0


def test_default_workers_reads_the_environment(monkeypatch):
    monkeypatch.setenv("HALO2_TORCH_SYNTH_WORKERS", "3")
    assert parallel_synthesis.default_workers() == 3
    monkeypatch.delenv("HALO2_TORCH_SYNTH_WORKERS")
    assert 1 <= parallel_synthesis.default_workers() <= 16


# -- BlockMulChainCircuit at K = 5 against the JAX package's bytes ----------

@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def synth_key(golden):
    params = Params.unsafe_setup(golden["k"], seed=golden["params_seed"],
                                 device="cpu")
    empty = BlockMulChainCircuit(golden["steps"], golden["blocks"])
    vk, pk = keygen(params, empty, floor_planner=FlatFloorPlanner,
                    device="cpu")
    return params, vk, pk


def _block_chain(golden, workers):
    a, b = golden["witness"]
    return BlockMulChainCircuit(golden["steps"], golden["blocks"], a, b,
                                workers=workers)


def test_block_chain_layout(golden):
    circuit = _block_chain(golden, 4)
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    n = 1 << golden["k"]
    assert circuit.rows_used() == int(cs.usable_rows(n) * 0.95)
    rows = [row for row, _, _ in circuit.layout()]
    assert rows[0] == 2 and len(rows) == golden["blocks"]
    assert circuit.expected_out() == golden["instances"][0][0]
    # the chain passes 2^64 in the first block: a0 degrades in the merge
    witness = WitnessCollection(cs, n, cs.usable_rows(n), golden["instances"])
    FlatFloorPlanner.synthesize(witness, circuit, config, cs.constants)
    assert not isinstance(witness.advice[0], np.ndarray)
    assert isinstance(witness.advice[1], np.ndarray)
    assert witness.max_assigned[0] == circuit.rows_used() - 1


@pytest.mark.parametrize("workers", [1, 4])
def test_block_chain_proof_bytes_equal_the_jax_package(golden, synth_key,
                                                       workers, tmp_path):
    params, vk, pk = synth_key
    assert vk.pinned() == golden["pinned_vk"]
    circuit = _block_chain(golden, workers)
    inst = golden["instances"]
    (proof, forks) = _fan_outs(lambda: create_proof(
        params, pk, circuit, inst, seed=golden["prover_seed"],
        floor_planner=FlatFloorPlanner, device="cpu"))
    assert forks == (1 if workers > 1 else 0)
    assert proof.hex() == golden["proof_hex"]
    assert verify_proof(params.verifier(1), vk, inst, proof)
    path = str(tmp_path / "witness.bin")
    create_witness(pk, circuit, inst, path, floor_planner=FlatFloorPlanner)
    with open(path, "rb") as fh:
        assert hashlib.sha256(fh.read()).hexdigest() == \
            golden["witness_sha256"]
