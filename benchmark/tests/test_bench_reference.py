"""The plain reference against the port on the CPU at small k: its
columns against the port's key, its pinned constraint systems against the
port's circuits, and whole runs of the harness coming out correct."""

import importlib

import pytest

import helpers
from benchmark.reference import bn254, check, cs as cs_mod, lagrange
from halo2_tpu_torch.fields.limbs import to_numpy
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.pinned import pinned_cs_str
from halo2_tpu_torch.poly.commitment import Params

CONFIGS = ["standard_plonk"]


@pytest.mark.parametrize("config", CONFIGS)
def test_pinned_text_is_the_ports(config):
    program = importlib.import_module(f"benchmark.circuits.{config}")
    spec = importlib.import_module(f"benchmark.reference.{config}")
    cs = ConstraintSystem()
    program.circuit(4).configure(cs)
    cs.chunk_lookups()
    cs.chunk_shuffles()
    assert cs.degree() == spec.DEGREE
    assert cs.usable_rows(16) == spec.usable_rows(4)
    if cs.num_selectors:
        cs.compress_selectors([[True] * 16] * cs.num_selectors)
    with open(spec.CS_FILE) as fh:
        text = fh.read().strip()
    assert text == pinned_cs_str(cs)
    parsed = cs_mod.parse(text)
    assert parsed.blinding_factors() == cs.blinding_factors()
    assert len(parsed.gates) == sum(len(g.polys) for g in cs.gates)
    assert len(parsed.permutation) == len(cs.permutation.columns)


def _lagrange_values(F, stack):
    """(16, C, n) Montgomery limbs -> C lists of canonical ints."""
    arr = to_numpy(F.from_mont(stack))
    C, n = arr.shape[1], arr.shape[2]
    return [[sum(int(arr[l, c, j]) << (16 * l) for l in range(16))
             for j in range(n)] for c in range(C)]


@pytest.mark.parametrize("config,k", [("standard_plonk", 4),
                                      ("standard_plonk", 5)])
def test_reference_columns_are_the_keys(config, k):
    """The reference's fixed and permutation columns, row by row, against
    the port's key; and the commitments it works out from s."""
    program = importlib.import_module(f"benchmark.circuits.{config}")
    spec = importlib.import_module(f"benchmark.reference.{config}")
    params = Params.unsafe_setup(k, seed=99, device="cpu")
    vk, pk = keygen(params, program.circuit(k),
                    floor_planner=program.FLOOR_PLANNER, device="cpu")
    F = pk.vk.domain.F
    cols = spec.columns({"witnesses": []}, k, 0, 1 << k)
    fixed = _lagrange_values(F, pk.fixed_lagrange)
    sigmas = _lagrange_values(F, pk.permutation_pk.sigmas_lagrange)
    for i, col in enumerate(fixed):
        assert [v % bn254.R for v in cols[f"fixed/{i}"]] == col, i
    for i, col in enumerate(sigmas):
        assert cols[f"sigma/{i}"] == col, i
    ref = check.Reference(config, k, 99, [], workers=1)
    assert ref.key_mismatch(vk.fixed_commitments,
                            vk.permutation.commitments) == 0


def test_lagrange_sums_split_over_workers():
    one = lagrange.column_sums("benchmark.reference.standard_plonk",
                               {"witnesses": [5]}, 6, 12345, workers=1)
    two = lagrange.column_sums("benchmark.reference.standard_plonk",
                               {"witnesses": [5]}, 6, 12345, workers=2)
    assert one == two


@pytest.mark.parametrize("cell", ["t.plonk.k4", "t.plonk.k4.x2"])
def test_run_is_correct(cell):
    result, compared = helpers.run(cell, 2**31 + 77)
    assert result["correct"], result
    assert all(v == 0 for _, v, _ in compared)
    assert result["proofs_checked"] == result["attempted"] >= 1
    assert set(result["metrics"]) == {"proof_s", "peak_mem_gb", "setup_s"}


def test_traced_run_is_correct():
    """--trace 1: the profiled proofs, then at least one under PhaseTimes;
    on the CPU the trace holds no device operation."""
    result, compared = helpers.run("t.plonk.k4", 2**33 + 5, trace=True)
    assert result["correct"], result
    assert result["proofs_checked"] == result["attempted"] >= 3
    metrics = result["metrics"]
    assert {"setup.keygen_s", "files.witness_load_s", "multiopen.s",
            "evaluator.evaluate_h_s", "device.idle_share"} <= set(metrics)
    assert metrics["device.idle_share"]["value"] == 100.0
    assert result["device"]["busy_s"] == 0
    assert result["breakdown"]["idle_gaps"]
