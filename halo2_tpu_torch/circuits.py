"""Example circuits of the class this package proves: a custom gate, copy
constraints, a constant and a public input.  Used by `chip_smoke.py` and
the tests."""

from __future__ import annotations

from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.plonk import Circuit

P = FR_MODULUS


class _MulConfig:
    def __init__(self, a0, a1, instance, s_mul, const_col):
        self.a0, self.a1 = a0, a1
        self.instance = instance
        self.s_mul = s_mul
        self.const_col = const_col


def _configure_mul(meta) -> _MulConfig:
    """2 advice + 1 instance + 1 fixed (constants) column, all advice and
    instance columns in the permutation, one selector, the gate
    s * (a0 * a1 - a0[next])."""
    a0 = meta.advice_column()
    a1 = meta.advice_column()
    instance = meta.instance_column()
    const_col = meta.fixed_column()
    meta.enable_constant(const_col)
    for c in (a0, a1, instance):
        meta.enable_equality(c)
    s_mul = meta.selector()

    def mul_gate(m):
        lhs = m.query_advice(a0, 0)
        rhs = m.query_advice(a1, 0)
        out = m.query_advice(a0, 1)
        s = m.query_selector(s_mul)
        return [("mul", s * (lhs * rhs - out))]

    meta.create_gate("mul", mul_gate)
    return _MulConfig(a0, a1, instance, s_mul, const_col)


class SimpleCircuit(Circuit):
    """out = (a * b) * (a * const7); exposes out at instance row 0."""

    def __init__(self, a=None, b=None):
        self.a, self.b = a, b

    def without_witnesses(self):
        return SimpleCircuit()

    def configure(self, meta):
        return _configure_mul(meta)

    @staticmethod
    def expected_out(a: int, b: int) -> int:
        return (a * b % P) * (a * 7 % P) % P

    def synthesize(self, config, layouter):
        a, b = self.a, self.b

        def mul_region(x, y):
            def fn(region):
                region.enable_selector("s", config.s_mul, 0)
                cx = region.assign_advice("x", config.a0, 0, x)
                cy = region.assign_advice("y", config.a1, 0, y)
                prod = None if (x is None or y is None) else x * y % P
                cp = region.assign_advice("xy", config.a0, 1, prod)
                return cx, cy, cp
            return fn

        # ab = a * b
        cx, cy, c_ab = layouter.assign_region("m1", mul_region(a, b))

        # a7 = a * 7 (7 from the constants column)
        def region2(region):
            region.enable_selector("s", config.s_mul, 0)
            ca = region.assign_advice("a2", config.a0, 0, a)
            region.assign_advice_from_constant("seven", config.a1, 0, 7)
            prod = None if a is None else a * 7 % P
            cp = region.assign_advice("a7", config.a0, 1, prod)
            # copy equality: this 'a' must equal the first region's 'a'
            region.constrain_equal(ca.cell, cx.cell)
            return cp
        c_a7 = layouter.assign_region("m2", region2)
        # out = ab * a7
        ab = None if (a is None or b is None) else a * b % P
        a7 = None if a is None else a * 7 % P

        def region3(region):
            region.enable_selector("s", config.s_mul, 0)
            c1 = region.assign_advice("ab", config.a0, 0, ab)
            c2 = region.assign_advice("a7", config.a1, 0, a7)
            region.constrain_equal(c1.cell, c_ab.cell)
            region.constrain_equal(c2.cell, c_a7.cell)
            out = None if (ab is None or a7 is None) else ab * a7 % P
            return region.assign_advice("out", config.a0, 1, out)
        c_out = layouter.assign_region("m3", region3)
        layouter.constrain_instance(c_out.cell, config.instance, 0)


class MulChainCircuit(Circuit):
    """A chain of `steps` mul gates that fills its rows:
    x_0 = a * 7 (7 from the constants column), x_{i+1} = x_i * b.

    Every step is a region of two rows (the gate's row and the row of its
    product); the next region's first cell is copy-constrained to that
    product, and the last product is exposed at instance row 0."""

    def __init__(self, steps: int, a=None, b=None):
        self.steps = steps
        self.a, self.b = a, b

    def without_witnesses(self):
        return MulChainCircuit(self.steps)

    def configure(self, meta):
        return _configure_mul(meta)

    @staticmethod
    def steps_for(k: int, fill: float = 0.95) -> int:
        """Steps that assign `fill` of the 2^k rows (two rows a step)."""
        return max(int((1 << k) * fill) // 2, 1)

    def expected_out(self) -> int:
        return self.a * 7 % P * pow(self.b, self.steps - 1, P) % P

    def synthesize(self, config, layouter):
        a, b = self.a, self.b
        prev_cell, prev_val = None, a

        for i in range(self.steps):
            def step(region, i=i, prev_cell=prev_cell, prev_val=prev_val):
                region.enable_selector("s", config.s_mul, 0)
                cx = region.assign_advice("x", config.a0, 0, prev_val)
                if i == 0:
                    region.assign_advice_from_constant("seven", config.a1,
                                                       0, 7)
                    rhs = 7
                else:
                    region.assign_advice("b", config.a1, 0, b)
                    region.constrain_equal(cx.cell, prev_cell)
                    rhs = b
                prod = (None if (prev_val is None or rhs is None)
                        else prev_val * rhs % P)
                return region.assign_advice("xy", config.a0, 1, prod), prod
            out, prev_val = layouter.assign_region(f"step{i}", step)
            prev_cell = out.cell
        layouter.constrain_instance(prev_cell, config.instance, 0)
