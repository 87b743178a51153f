"""tests/test_lookup_any.py on the port: two lookup_any arguments against
non-fixed table columns (an even table in an advice column, an odd table
in an instance column) behind complex selectors, through the port's
MockProver, with the failure lists equal to the JAX package's; and the
same three cases on the port's LookupAnyCircuit (a fixed table)."""

import dataclasses

import pytest

from halo2_tpu.dev import MockProver as JaxMock
from halo2_tpu_torch.circuits import LookupAnyCircuit
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.plonk import Circuit
from tests import test_lookup_any as jax_side
from tests.data.gen_torch_golden import LookupAnyCircuit as JaxLookupAny

K = jax_side.K
EVEN_LOOKUP, ODD_LOOKUP = jax_side.EVEN_LOOKUP, jax_side.ODD_LOOKUP


class MyConfig:
    def __init__(self, input_col, q_even, table_even, q_odd, table_odd):
        self.input = input_col
        self.q_even = q_even
        self.table_even = table_even
        self.q_odd = q_odd
        self.table_odd = table_odd

    @classmethod
    def configure(cls, meta):
        config = cls(input_col=meta.advice_column(),
                     q_even=meta.complex_selector(),
                     table_even=meta.advice_column(),
                     q_odd=meta.complex_selector(),
                     table_odd=meta.instance_column())
        meta.lookup_any("even number", lambda m: [
            (m.query_selector(config.q_even)
             * m.query_advice(config.input, 0),
             m.query_advice(config.table_even, 0))])
        meta.lookup_any("odd number", lambda m: [
            (m.query_selector(config.q_odd)
             * m.query_advice(config.input, 0),
             m.query_instance(config.table_odd, 0))])
        return config

    def witness(self, layouter, selector, name, value):
        def fn(region):
            region.enable_selector(name, selector, 0)
            region.assign_advice(f"{name} input", self.input, 0, value)
        layouter.namespace(f"witness {name} numbers").assign_region(
            f"witness {name} number", fn)

    def load_even_lookup(self, layouter, values):
        def fn(region):
            for offset, value in enumerate(values):
                region.assign_advice("even table value", self.table_even,
                                     offset, value)
        layouter.namespace("witness even numbers").assign_region(
            "load values for even lookup table", fn)


class MyCircuit(Circuit):
    def __init__(self, even_lookup=(), even_witnesses=(), odd_witnesses=()):
        self.even_lookup = list(even_lookup)
        self.even_witnesses = list(even_witnesses)
        self.odd_witnesses = list(odd_witnesses)

    def without_witnesses(self):
        return MyCircuit()

    def configure(self, meta):
        return MyConfig.configure(meta)

    def synthesize(self, config, layouter):
        config.load_even_lookup(layouter, self.even_lookup)
        for even in self.even_witnesses:
            config.witness(layouter, config.q_even, "even", even)
        for odd in self.odd_witnesses:
            config.witness(layouter, config.q_odd, "odd", odd)


def _fields(fails):
    return [(repr(f), f.kind, f.detail,
             None if f.location is None else dataclasses.astuple(f.location))
            for f in fails]


CASES = {
    # name: (even witnesses, instance column, satisfied)
    "accepts_correct_instance": ([0, 2, 4], ODD_LOOKUP, True),
    "rejects_even_instance": ([0, 2, 4], EVEN_LOOKUP, False),
    "rejects_nonmember_witness": ([0, 2, 10], ODD_LOOKUP, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lookup_any_cases_equal_the_jax_package(name):
    evens, inst, satisfied = CASES[name]
    want = JaxMock.run(K, jax_side.MyCircuit(EVEN_LOOKUP, evens, [1, 3, 5]),
                       [inst]).verify()
    got = MockProver.run(K, MyCircuit(EVEN_LOOKUP, evens, [1, 3, 5]),
                         [inst]).verify()
    assert _fields(got) == _fields(want)
    assert (got == []) == satisfied


@pytest.mark.parametrize("values", [LookupAnyCircuit.VALUES,
                                    [3, 1, 4, 1, 9, 7, 2, 6],
                                    [8, 8, 8, 8, 8, 8, 8, 8]],
                         ids=["in_table", "one_outside", "all_outside"])
def test_fixed_table_lookup_any_equals_the_jax_package(values):
    want = JaxMock.run(4, JaxLookupAny(values), []).verify()
    got = MockProver.run(4, LookupAnyCircuit(values), []).verify()
    assert _fields(got) == _fields(want)
    assert (got == []) == (values == LookupAnyCircuit.VALUES)
    assert all(f.kind == "lookup" for f in got)
