"""The port's logup / shuffle / range-check modules against the JAX
package, on the CPU (`device="cpu"`, the kernels' plain versions).

The JAX side is read from tests/data/torch_golden_args.json (written by
tests/data/gen_torch_golden.py; tests/test_torch_args_prover.py holds it
against the live JAX package): `_multiplicities_device` on tables with
repeated entries, one lookup's `multiplicities` + `commit_zs` over two
input sets (two inputs, then one) and one shuffle group's `commit_product`
over two units, at n = 32, as canonical integers.  The range-check fill is
held against the JAX package's own `fill_and_sort` on the JAX
WitnessCollection.  Tolerance: none, integers are compared for equality.
"""

import json
import os
import random
import types

import numpy as np
import pytest
import torch

from halo2_tpu.plonk.prover import WitnessCollection as JWitnessCollection
from halo2_tpu.plonk.range_check import fill_and_sort as j_fill_and_sort

from halo2_tpu_torch.circuit import SimpleFloorPlanner
from halo2_tpu_torch.circuits import RangeCheckCircuit
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P, fr
from halo2_tpu_torch.fields.limbs import ints_to_limbs_np, to_tensor
from halo2_tpu_torch.plonk import logup_prover, shuffle_prover
from halo2_tpu_torch.plonk.circuit import ConstraintSystem, eval_expression_host
from halo2_tpu_torch.plonk.expr_eval import ExprCtx
from halo2_tpu_torch.plonk.prover import (WitnessCollection,
                                          _quantize_max_bits, m_commit_bits)
from halo2_tpu_torch.poly.commitment import Params

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_args.json")
F = fr("cpu")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


def _std(values):
    return to_tensor(ints_to_limbs_np(values), "cpu")


class _Blinding:
    def __init__(self, bf):
        self.bf = bf

    def blinding_factors(self):
        return self.bf


def _domain(n):
    return types.SimpleNamespace(F=F, n=n)


@pytest.mark.parametrize("form", ["standard", "montgomery"])
def test_multiplicities_credit_the_first_table_row(golden, form):
    case = golden["logup"]["multiplicities"][0]
    enc = _std if form == "standard" else F.encode
    counts, ok, max_count = logup_prover.multiplicity_counts(
        enc(case["table"]), enc(case["inputs"]))
    assert ok is case["ok"] is True
    assert counts.tolist() == case["counts"]
    assert max_count == case["max_count"]
    # a repeated table value counts only at its first row
    table = case["table"]
    for i, v in enumerate(table):
        if v in table[:i]:
            assert case["counts"][i] == 0
    assert sum(case["counts"]) == len(case["inputs"])


def test_missing_input_value_raises(golden):
    case = golden["logup"]["multiplicities"][1]
    _, ok, _ = logup_prover.multiplicity_counts(_std(case["table"]),
                                                _std(case["inputs"]))
    assert ok is case["ok"] is False
    u = len(case["table"])
    table = F.encode(case["table"] + [0] * 4)
    inputs = F.encode(case["inputs"][:u] + [0] * 4)
    with pytest.raises(ValueError, match="not present in table"):
        logup_prover.multiplicities(table, [inputs], u, random.Random(0))


def _grand_sum_inputs(rec):
    table = F.encode(rec["table"])
    sets = [[F.encode(c) for c in s] for s in rec["sets"]]
    return table, sets


def test_m_and_its_bits(golden):
    rec = golden["logup"]["grand_sums"]
    u = rec["n"] - (rec["bf"] + 1)
    table, sets = _grand_sum_inputs(rec)
    m, m_bits = logup_prover.multiplicities(
        table, [c for s in sets for c in s], u, random.Random(rec["rng_seed"]))
    assert F.decode(m) == rec["m"]
    assert m_bits == rec["m_bits"] == max(rec["m"][:u]).bit_length()


def test_grand_sums_chain_and_telescope(golden):
    rec = golden["logup"]["grand_sums"]
    n, bf = rec["n"], rec["bf"]
    u = n - (bf + 1)
    table, sets = _grand_sum_inputs(rec)
    rng = random.Random(rec["rng_seed"])
    m, _ = logup_prover.multiplicities(table, [c for s in sets for c in s],
                                       u, rng)
    zs = logup_prover.commit_zs(_domain(n), _Blinding(bf), table, sets, m,
                                rec["beta"], rng)
    got = [F.decode(z) for z in zs]
    assert got == rec["zs"]
    assert got[0][0] == 0
    assert got[1][0] == got[0][u]          # chained through last_z
    assert got[-1][u] == 0                 # the grand sum telescopes


def test_shuffle_product_closes_to_one(golden):
    rec = golden["shuffle"]
    n, bf = rec["n"], rec["bf"]
    z = shuffle_prover.commit_product(
        _domain(n), _Blinding(bf), [F.encode(c) for c in rec["inputs"]],
        [F.encode(c) for c in rec["shuffles"]], rec["beta"],
        random.Random(rec["rng_seed"]))
    got = F.decode(z)
    assert got == rec["z"]
    assert got[0] == 1 and got[n - (bf + 1)] == 1


def test_compress_on_the_lagrange_context():
    """theta-compression of advice, instance and fixed table expressions
    (a rotation and a constant among them) on a Lagrange context against a
    host model of the same expressions."""
    cs = ConstraintSystem()
    a, b = cs.advice_column(), cs.advice_column()
    inst, fx = cs.instance_column(), cs.fixed_column()
    cs.lookup_any("any", lambda m: [
        (m.query_advice(a, 0), m.query_advice(b, 1)),
        (m.query_advice(a, 0) * 3 + 1, m.query_instance(inst, 0)),
        (m.query_fixed(fx, -1), m.query_fixed(fx, 0) + m.query_advice(b, 0))])
    cs.chunk_lookups()
    n = 16
    rng = np.random.default_rng(5)
    cols = {kind: [[int.from_bytes(rng.bytes(32), "little") % P
                    for _ in range(n)] for _ in range(count)]
            for kind, count in (("advice", 2), ("instance", 1), ("fixed", 1))}
    ctx = ExprCtx(*(torch.stack([F.encode(c) for c in cols[kind]], dim=1)
                    for kind in ("advice", "fixed", "instance")),
                  rot_scale=1, length=n)
    theta = 0x1234567 << 200
    table, sets = logup_prover.compress(cs.lookups[0], ctx,
                                        F.encode_scalar(theta))

    def host(exprs, row):
        def q(kind):
            return lambda e: cols[kind][e.column_index][(row + e.rotation) % n]
        acc = 0
        for e in exprs:
            acc = (acc * theta + eval_expression_host(
                e, q("fixed"), q("advice"), q("instance"))) % P
        return acc

    lk = cs.lookups[0]
    assert F.decode(table) == [host(lk.table_expressions, r)
                               for r in range(n)]
    for s_dev, s_exprs in zip(sets, lk.input_expressions_sets):
        for col, exprs in zip(s_dev, s_exprs):
            assert F.decode(col) == [host(exprs, r) for r in range(n)]


def _rc_witness(cls, values, usable=26):
    """A witness of RangeCheckCircuit(values) in a 32-row domain, before
    the fill, for either package's WitnessCollection."""
    cs = ConstraintSystem()
    config = RangeCheckCircuit(usable=usable).configure(cs)
    cs.chunk_lookups()
    cs.chunk_shuffles()
    assert cs.usable_rows(32) == usable
    w = cls(cs, 32, usable, [])
    SimpleFloorPlanner.synthesize(w, RangeCheckCircuit(values, usable),
                                  config, cs.constants)
    return cs, w


def test_fill_and_sort_through_the_witness_collection():
    values = [1, 0, 2]
    cs, w = _rc_witness(WitnessCollection, values)
    rel = cs.range_check[0]
    origin, sort = rel.origin.index, rel.sort.index
    assert (w.max_value[origin], w.max_value[sort]) == (2, 0)
    w.fill_range_checks()
    _, jw = _rc_witness(JWitnessCollection, values)
    j_fill_and_sort(jw.advice, rel, 26, jw.max_assigned[origin])
    for mine, theirs in zip(w.advice, jw.advice):
        assert [int(v) for v in mine] == [int(v) for v in theirs]
    # the tail MIN..MAX descending from the last usable row, then sorted
    assert [int(v) for v in w.advice[origin][18:26]] == list(range(7, -1, -1))
    assert [int(v) for v in w.advice[sort][:26]] == sorted(
        int(v) for v in w.advice[origin][:26])
    # the commit bounds rise to MAX, which the filled cells reach
    assert (w.max_value[origin], w.max_value[sort]) == (7, 7)


def test_fill_and_sort_refuses_a_value_out_of_range():
    _, w = _rc_witness(WitnessCollection, [3, 99])
    with pytest.raises(ValueError, match="outside"):
        w.fill_range_checks()


def test_m_commitment_bound_covers_the_blinding_tail():
    """At K = 5 every count of m is below 2^9: the bound of the counts
    alone (the reference's, 9 bits) does not cover the u16 blinding rows,
    whose high bits a bounded-window MSM drops; the port's bound covers
    them and gives the full commitment."""
    k, bf = 5, 3
    n = 1 << k
    u = n - (bf + 1)
    table = F.encode(list(range(10)) + [0] * (n - 10))
    inputs = F.encode([3, 1, 4, 1, 5, 9, 2, 6] + [0] * (n - 8))
    m, m_bits = logup_prover.multiplicities(table, [inputs], u,
                                            random.Random(3))
    tail_max = max(F.decode(m)[u:])
    assert m_bits < 9 and _quantize_max_bits(m_bits) == 9
    assert 1 << 9 <= tail_max < 1 << 16
    assert tail_max < 1 << m_commit_bits(m_bits)
    params = Params.unsafe_setup(k, seed=99, device="cpu")
    full, ours = params.commit_many_affine(
        [m, m], [256, m_commit_bits(m_bits)], base="lagrange")
    assert ours == full
