#!/usr/bin/env python3
"""Two-chip composition on the port: an Add chip and a Mul chip composed
into a Field chip computing d = (a + b) * c, laid out by the V1 two-pass
floor planner, the result exposed as a public input (the reference's
examples/two-chip.rs).  MockProver checks it (host only, no card).

    python3 examples/torch_two_chip_example.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from halo2_tpu_torch.circuit import Chip, V1FloorPlanner  # noqa: E402
from halo2_tpu_torch.dev import MockProver  # noqa: E402
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P  # noqa: E402
from halo2_tpu_torch.plonk import Circuit  # noqa: E402


class _BinaryChip(Chip):
    """out = op(lhs, rhs) over one advice-column pair: the gate
    s * (op(a0, a1) - a0[next])."""

    NAME = OP = None

    @classmethod
    def configure(cls, meta, advice):
        sel = meta.selector()

        def gate(m):
            lhs = m.query_advice(advice[0], 0)
            rhs = m.query_advice(advice[1], 0)
            out = m.query_advice(advice[0], 1)
            return [(cls.NAME, m.query_selector(sel)
                     * (cls.OP(lhs, rhs) - out))]

        meta.create_gate(cls.NAME, gate)
        return cls({"advice": advice, "sel": sel})

    def apply(self, layouter, a, b):
        cfg = self.config

        def fn(region):
            region.enable_selector(self.NAME, cfg["sel"], 0)
            ca = region.assign_advice("lhs", cfg["advice"][0], 0, a.value)
            cb = region.assign_advice("rhs", cfg["advice"][1], 0, b.value)
            region.constrain_equal(ca.cell, a.cell)
            region.constrain_equal(cb.cell, b.cell)
            out = None if a.value is None or b.value is None \
                else self.OP(a.value, b.value) % P
            return region.assign_advice("out", cfg["advice"][0], 1, out)

        return layouter.assign_region(self.NAME, fn)


class AddChip(_BinaryChip):
    """d = a + b (two-chip.rs AddChip)."""
    NAME = "add"
    OP = staticmethod(lambda x, y: x + y)


class MulChip(_BinaryChip):
    """d = a * b (two-chip.rs MulChip)."""
    NAME = "mul"
    OP = staticmethod(lambda x, y: x * y)


class FieldChip(Chip):
    """Composes AddChip and MulChip: add_and_mul = (a + b) * c."""

    @classmethod
    def configure(cls, meta, advice, instance):
        for c in advice:
            meta.enable_equality(c)
        meta.enable_equality(instance)
        return cls({"advice": advice, "instance": instance,
                    "add": AddChip.configure(meta, advice),
                    "mul": MulChip.configure(meta, advice)})

    def load_private(self, layouter, value):
        col = self.config["advice"][0]
        return layouter.assign_region(
            "load private",
            lambda region: region.assign_advice("private", col, 0, value))

    def add_and_mul(self, layouter, a, b, c):
        ab = self.config["add"].apply(layouter.namespace("a + b"), a, b)
        return self.config["mul"].apply(layouter.namespace("(a+b) * c"), ab,
                                        c)

    def expose_public(self, layouter, num, row):
        layouter.constrain_instance(num.cell, self.config["instance"], row)


class FieldCircuit(Circuit):
    def __init__(self, a=None, b=None, c=None):
        self.a, self.b, self.c = a, b, c

    def without_witnesses(self):
        return FieldCircuit()

    def configure(self, meta):
        advice = [meta.advice_column(), meta.advice_column()]
        return FieldChip.configure(meta, advice, meta.instance_column())

    def synthesize(self, config, layouter):
        a = config.load_private(layouter.namespace("load a"), self.a)
        b = config.load_private(layouter.namespace("load b"), self.b)
        c = config.load_private(layouter.namespace("load c"), self.c)
        d = config.add_and_mul(layouter, a, b, c)
        config.expose_public(layouter.namespace("expose d"), d, 0)


def main():
    a, b, c = 2, 3, 4
    d = (a + b) * c % P
    MockProver.run(4, FieldCircuit(a, b, c), [[d]],
                   floor_planner=V1FloorPlanner).assert_satisfied()
    print(f"two-chip circuit satisfied: ({a} + {b}) * {c} = {d}")
    fails = MockProver.run(4, FieldCircuit(a, b, c), [[d + 1]],
                           floor_planner=V1FloorPlanner).verify()
    if not fails:
        raise AssertionError("a wrong public input must fail")
    print(f"wrong instance rejected with {len(fails)} failure(s):")
    for f in fails:
        print(f"  {f!r}")


if __name__ == "__main__":
    main()
