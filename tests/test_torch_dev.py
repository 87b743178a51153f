"""The port's dev tools (halo2_tpu_torch/dev) against the JAX package's
(halo2_tpu/dev, host only, live calls): MockProver's failure lists, field
by field and in order (kind, detail, gate, constraint, location, column,
offset, and the repr), on the circuits of tests/test_mock.py and the
negative cases of test_lookup_shuffle.py, test_range_check.py,
test_all_args.py, test_errors.py, test_assigned.py,
test_v1_planner.py::test_mock_with_v1 and test_plonk_api.py; CircuitCost's
fields and estimates; format_gates' text; and CircuitLayout's SVG, byte
for byte.  Each circuit exists in both packages (the port's copies in
halo2_tpu_torch/circuits.py or here); BlockMulChainCircuit uses nothing
but the objects it is handed, so both packages run the port's class."""

import dataclasses
import functools
import importlib.util
import os
import random

import pytest

from halo2_tpu.circuit import FlatFloorPlanner as JaxFlat
from halo2_tpu.circuit import V1FloorPlanner as JaxV1
from halo2_tpu.dev import MockProver as JaxMock
from halo2_tpu.dev.cost import CircuitCost as JaxCost
from halo2_tpu.dev.gates import format_gates as jax_format_gates
from halo2_tpu.dev.graph import CircuitLayout as JaxLayout
from halo2_tpu.plonk import Circuit as JaxCircuit
from halo2_tpu.plonk.assigned import Assigned as JaxAssigned
from halo2_tpu.plonk.circuit import ConstraintSystem as JaxCS
from halo2_tpu.plonk.error import InvalidInstancesError as JaxInvalid
from halo2_tpu_torch import circuits as port
from halo2_tpu_torch.circuit import FlatFloorPlanner, SimpleFloorPlanner
from halo2_tpu_torch.circuit import V1FloorPlanner
from halo2_tpu_torch.dev import (CircuitCost, CircuitLayout, LayoutTracker,
                                 MockProver, format_gates)
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P
from halo2_tpu_torch.plonk import Circuit
from halo2_tpu_torch.plonk.assigned import Assigned
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.error import InvalidInstancesError
from tests import test_e2e, test_lookup_shuffle, test_plonk_api
from tests import test_range_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_all_args():
    spec = importlib.util.spec_from_file_location(
        "bench_all_args", os.path.join(ROOT, "examples", "bench_all_args.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.AllArgsCircuit


# -- circuits written once, run on both packages' DSLs -------------------------

def _bad_gate(self, config, layouter):
    def fn(region):
        region.enable_selector("s", config.s_mul, 0)
        region.assign_advice("x", config.a0, 0, 3)
        region.assign_advice("y", config.a1, 0, 5)
        return region.assign_advice("xy", config.a0, 1, 16)
    c = layouter.assign_region("m1", fn)
    layouter.constrain_instance(c.cell, config.instance, 0)


def _unassigned(self, config, layouter):
    def fn(region):
        region.enable_selector("s", config.s_mul, 0)
        region.assign_advice("x", config.a0, 0, 3)
        # a1@0 (rhs) and a0@1 (out) are never assigned
    layouter.assign_region("m1", fn)


def _ok_then_bad(self, config, layouter):
    def ok(region):
        region.enable_selector("s", config.s_mul, 0)
        region.assign_advice("x", config.a0, 0, 2)
        region.assign_advice("y", config.a1, 0, 3)
        region.assign_advice("xy", config.a0, 1, 6)
    layouter.assign_region("m_ok", ok)
    _bad_gate(self, config, layouter)


def _simple_with(synthesize):
    """The SimpleCircuit of each package with `synthesize` in place of its
    own: (JAX circuit, port circuit)."""
    jax_cls = type("Jax", (test_e2e.SimpleCircuit,),
                   {"synthesize": synthesize})
    port_cls = type("Port", (port.SimpleCircuit,),
                    {"synthesize": synthesize})
    return jax_cls(), port_cls()


def _div_circuit(base, assigned, bad_row=None):
    """tests/test_assigned.py's DivCircuit on one package's DSL:
    c[i] = a[i] / b[i] as a deferred rational, the gate b*c - a = 0;
    `bad_row`'s c is (a + 1) / b."""
    class DivCircuit(base):
        ROWS = 12

        def without_witnesses(self):
            return self

        def configure(self, meta):
            a, b, c = (meta.advice_column() for _ in range(3))
            s = meta.selector()
            meta.create_gate("div", lambda m: [
                ("b*c-a", m.query_selector(s) *
                 (m.query_advice(b, 0) * m.query_advice(c, 0)
                  - m.query_advice(a, 0)))])
            return a, b, c, s

        def synthesize(self, config, layouter):
            a_col, b_col, c_col, s = config
            r = random.Random(3)

            def fn(region):
                for i in range(self.ROWS):
                    av, bv = r.randrange(P), r.randrange(1, P)
                    region.enable_selector("s", s, i)
                    region.assign_advice("a", a_col, i, av)
                    region.assign_advice("b", b_col, i, bv)
                    num = av + 1 if i == bad_row else av
                    region.assign_advice("c", c_col, i,
                                         assigned.rational(num, bv))
            layouter.assign_region("divs", fn)
    return DivCircuit()


def _block_chain(k, wrong=False):
    steps = port.BlockMulChainCircuit.steps_for(k, 4)
    c = port.BlockMulChainCircuit(steps, 4, 3, 1000003, workers=2)
    return c, [[(c.expected_out() + wrong) % P]]


def _simple(a=3, b=5):
    return test_e2e.SimpleCircuit(a, b), port.SimpleCircuit(a, b)


OUT = test_e2e.expected_out(3, 5)
LS = test_lookup_shuffle
BAD_A = [77] + LS.VALS_A[1:]
BAD_B = [2] + LS.VALS_B[1:]
ALL_ARGS_K = 9


def _all_args(k, wrong=False):
    rows = port.AllArgsCircuit.usable_rows(k)
    jax_c, port_c = _jax_all_args()(rows), port.AllArgsCircuit(rows)
    return (jax_c, port_c), [[port_c.instance() + wrong]]


def _case(name):
    """(k, (JAX circuit, port circuit), instances, (JAX planner, port
    planner)) of a MockProver case."""
    none = (None, None)
    if name == "simple_satisfied":
        return 4, _simple(), [[OUT]], none
    if name == "simple_bad_instance":
        return 4, _simple(), [[999]], none
    if name == "bad_gate":
        return 4, _simple_with(_bad_gate), [[16]], none
    if name == "cell_not_assigned":
        return 4, _simple_with(_unassigned), [[0]], none
    if name == "v1_satisfied":
        return 4, _simple(), [[OUT]], (JaxV1, V1FloorPlanner)
    if name == "v1_bad_instance":
        return 4, _simple(), [[OUT + 1]], (JaxV1, V1FloorPlanner)
    if name == "lookup_shuffle_satisfied":
        return 5, (LS.LookupShuffleCircuit(LS.VALS_A, LS.VALS_B),
                   port.LookupShuffleCircuit(LS.VALS_A, LS.VALS_B)), [], none
    if name == "lookup_out_of_range":
        return 5, (LS.LookupShuffleCircuit(BAD_A, LS.VALS_B),
                   port.LookupShuffleCircuit(BAD_A, LS.VALS_B)), [], none
    if name == "shuffle_not_a_permutation":
        return 5, (LS.LookupShuffleCircuit(LS.VALS_A, BAD_B),
                   port.LookupShuffleCircuit(LS.VALS_A, BAD_B)), [], none
    if name == "range_check_satisfied":
        vals = test_range_check.VALUES
        return 5, (test_range_check.RangeCheckCircuit(vals),
                   port.RangeCheckCircuit(vals)), [], none
    if name in ("all_args_satisfied", "all_args_wrong_instance"):
        pair, inst = _all_args(ALL_ARGS_K, name.endswith("instance"))
        return ALL_ARGS_K, pair, inst, (JaxFlat, FlatFloorPlanner)
    if name in ("div_satisfied", "div_wrong_quotient"):
        bad = 5 if name.endswith("quotient") else None
        return 5, (_div_circuit(JaxCircuit, JaxAssigned, bad),
                   _div_circuit(Circuit, Assigned, bad)), [], none
    if name == "plonk_api_satisfied":
        api = test_plonk_api
        return api.K, (api.MyCircuit(api.A_VALUE, api.LOOKUP_TABLE),
                       port.PlonkApiCircuit(port.PlonkApiCircuit.A_VALUE)), \
            [[api.INSTANCE]], none
    if name in ("block_chain_satisfied", "block_chain_wrong_instance"):
        c, inst = _block_chain(5, name.endswith("instance"))
        return 5, (c, c), inst, (JaxFlat, FlatFloorPlanner)
    raise ValueError(name)


MOCK_CASES = ["simple_satisfied", "simple_bad_instance", "bad_gate",
              "cell_not_assigned", "v1_satisfied", "v1_bad_instance",
              "lookup_shuffle_satisfied", "lookup_out_of_range",
              "shuffle_not_a_permutation", "range_check_satisfied",
              "all_args_satisfied", "all_args_wrong_instance",
              "div_satisfied", "div_wrong_quotient", "plonk_api_satisfied",
              "block_chain_satisfied", "block_chain_wrong_instance"]
SATISFIED = {c for c in MOCK_CASES if c.endswith("satisfied")}


def _fields(f):
    loc = None if f.location is None else dataclasses.astuple(f.location)
    return (repr(f), f.kind, f.detail, f.gate, f.constraint, loc, f.column,
            f.offset)


@pytest.mark.parametrize("name", MOCK_CASES)
def test_mock_failures_equal_the_jax_package(name):
    k, (jax_c, port_c), inst, (jax_fp, port_fp) = _case(name)
    want = [_fields(f) for f in
            JaxMock.run(k, jax_c, inst, floor_planner=jax_fp).verify()]
    prover = MockProver.run(k, port_c, inst, floor_planner=port_fp)
    got = [_fields(f) for f in prover.verify()]
    assert got == want
    assert (got == []) == (name in SATISFIED)
    if name in SATISFIED:
        prover.assert_satisfied()
    else:
        with pytest.raises(AssertionError, match="MockProver failures"):
            prover.assert_satisfied()


def test_mock_failure_kinds():
    """What tests/test_mock.py and test_lookup_shuffle.py assert of each
    failure list, on the port's."""
    def kinds(name):
        k, (_, c), inst, (_, fp) = _case(name)
        return [f for f in MockProver.run(k, c, inst,
                                          floor_planner=fp).verify()]
    assert any(f.kind == "permutation" and hex(999) in f.detail
               and hex(OUT) in f.detail for f in kinds("simple_bad_instance"))
    assert any(f.kind == "gate" for f in kinds("bad_gate"))
    cna = [f for f in kinds("cell_not_assigned")
           if f.kind == "cell_not_assigned"]
    assert {("advice", 1), ("advice", 0)} <= {f.column for f in cna}
    assert cna[0].location.region_name == "m1"
    assert any(f.kind == "lookup" for f in kinds("lookup_out_of_range"))
    assert any(f.kind == "shuffle" for f in kinds("shuffle_not_a_permutation"))
    assert any(f.kind == "gate" for f in kinds("div_wrong_quotient"))


def test_mock_verify_at_rows():
    jax_c, port_c = _simple_with(_ok_then_bad)
    for mock, c in ((JaxMock, jax_c), (MockProver, port_c)):
        prover = mock.run(4, c, [[16]])
        early = prover.verify_at_rows(range(0, 2), range(0, 2))
        assert not any(f.kind == "gate" for f in early)
        full = prover.verify_at_rows(range(0, 4), range(0, 4))
        assert any(f.kind == "gate" for f in full)
        with pytest.raises(ValueError):
            prover.verify_at_rows([10 ** 9], [])
    want = JaxMock.run(4, jax_c, [[16]]).verify_at_rows(range(4), range(4))
    got = MockProver.run(4, port_c, [[16]]).verify_at_rows(range(4),
                                                           range(4))
    assert [_fields(f) for f in got] == [_fields(f) for f in want]


def test_mock_refusals():
    # out-of-range values stop the range check's sort (test_range_check)
    for mock, c in ((JaxMock, test_range_check.RangeCheckCircuit([3, 99])),
                    (MockProver, port.RangeCheckCircuit([3, 99]))):
        with pytest.raises(ValueError):
            mock.run(5, c, []).verify()
    # a missing instance column (test_errors)
    with pytest.raises(JaxInvalid):
        JaxMock.run(4, test_e2e.SimpleCircuit(3, 5), [])
    with pytest.raises(InvalidInstancesError):
        MockProver.run(4, port.SimpleCircuit(3, 5), [])


def test_expression_lazy_and_complexity():
    """tests/test_mock.py's Expression.evaluate_lazy and complexity() on
    the port's expressions."""
    from halo2_tpu_torch.plonk.circuit import Constant, Product, Sum
    zero, five = Constant(0), Constant(5)
    calls = []

    def counting_const(v):
        calls.append(v)
        return v

    h = (counting_const, None, None, None,
         lambda a: (-a) % P, lambda a, b: (a + b) % P,
         lambda a, b: a * b % P, lambda a, s: a * s % P)
    assert Product(zero, five).evaluate_lazy(*h, 0) == 0
    assert calls == [0]
    calls.clear()
    assert Product(five, zero).evaluate_lazy(*h, 0) == 0
    assert calls == [5, 0]
    assert Constant(3).complexity() == 0
    assert Sum(five, zero).complexity() == 15
    assert Product(five, zero).complexity() == 30


# -- CircuitCost, format_gates, CircuitLayout ----------------------------------

def _shape_case(name):
    """(k, JAX circuit, port circuit) without witnesses."""
    if name == "simple":
        return 4, test_e2e.SimpleCircuit(), port.SimpleCircuit()
    if name == "lookup_shuffle":
        return 5, LS.LookupShuffleCircuit(), port.LookupShuffleCircuit()
    if name == "range_check":
        return 5, test_range_check.RangeCheckCircuit(), \
            port.RangeCheckCircuit()
    if name == "all_args":
        (jax_c, port_c), _ = _all_args(ALL_ARGS_K)
        return ALL_ARGS_K, jax_c, port_c
    if name == "plonk_api":
        api = test_plonk_api
        return api.K, api.MyCircuit(None, api.LOOKUP_TABLE), \
            port.PlonkApiCircuit()
    if name == "div":
        return 5, _div_circuit(JaxCircuit, JaxAssigned), \
            _div_circuit(Circuit, Assigned)
    if name == "block_chain":
        c, _ = _block_chain(5)
        return 5, c, c
    raise ValueError(name)


SHAPES = ["simple", "lookup_shuffle", "range_check", "all_args", "plonk_api",
          "div", "block_chain"]
FLAT = ("all_args", "block_chain")      # laid out with absolute rows
# CircuitLayout synthesizes with SimpleFloorPlanner: the circuits laid out
# with absolute rows (FlatFloorPlanner) are left out
LAYOUTS = ["simple", "lookup_shuffle", "range_check", "plonk_api", "div"]


@pytest.mark.parametrize("name", SHAPES)
def test_circuit_cost_equals_the_jax_package(name, monkeypatch):
    k, jax_c, port_c = _shape_case(name)
    planner = None
    if name in FLAT:
        # the JAX package's measure() takes no planner: hand its
        # rebuild_cs the circuit's FlatFloorPlanner
        import halo2_tpu.plonk.keygen as jax_keygen
        monkeypatch.setattr(jax_keygen, "rebuild_cs", functools.partial(
            jax_keygen.rebuild_cs, floor_planner=JaxFlat))
        planner = FlatFloorPlanner
    want = JaxCost.measure(k, jax_c)
    got = CircuitCost.measure(k, port_c, floor_planner=planner)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for method in ("proof_points", "proof_scalars", "proof_size_gwc",
                   "prover_msms", "prover_ntts"):
        assert getattr(got, method)() == getattr(want, method)()


@pytest.mark.parametrize("name", SHAPES)
def test_format_gates_equals_the_jax_package(name):
    _, jax_c, port_c = _shape_case(name)
    jax_cs, port_cs = JaxCS(), ConstraintSystem()
    jax_c.configure(jax_cs)
    port_c.configure(port_cs)
    text = format_gates(port_cs)
    assert text == jax_format_gates(jax_cs)
    for gate in port_cs.gates:
        assert f"gate {gate.name}:" in text


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_svg_equals_the_jax_package(name, tmp_path):
    k, jax_c, port_c = _shape_case(name)
    path = str(tmp_path / "layout.svg")
    svg = CircuitLayout().render(port_c, k, path=path)
    assert svg == JaxLayout().render(jax_c, k)
    with open(path) as fh:
        assert fh.read() == svg
    assert svg.startswith("<svg") and svg.rstrip().endswith("</svg>")
    # a row cap cuts both the same way
    assert CircuitLayout(max_rows=3).render(port_c, k) == \
        JaxLayout(max_rows=3).render(jax_c, k)


def test_layout_tracker_regions():
    """tests/test_dev_graph.py's tracker checks on the port."""
    cs = ConstraintSystem()
    circuit = port.SimpleCircuit()
    config = circuit.configure(cs)
    tracker = LayoutTracker(cs, 16)
    SimpleFloorPlanner.synthesize(tracker, circuit.without_witnesses(),
                                  config, cs.constants)
    assert [r.name for r in tracker.regions] == ["m1", "m2", "m3"]
    assert tracker.regions[0].rows == [0, 1]
    assert all(r.rows[1] - r.rows[0] >= 1 for r in tracker.regions)
    assert tracker.equality
    svg = CircuitLayout().render(circuit, k=4)
    assert "stroke-dasharray" in svg
    assert ">a0<" in svg and ">f0<" in svg and ">i0<" in svg
