"""Example circuits of the class this package proves: custom gates, copy
constraints, a constant and a public input (`SimpleCircuit`,
`MulChainCircuit`, and `BlockMulChainCircuit`, whose regions synthesize in
forked workers); logup lookups with two input sets and a shuffle
(`LookupShuffleCircuit`); a range check by sorted column
(`RangeCheckCircuit`); every argument in one proof (`AllArgsCircuit`); the
reference's integration spec circuit (`PlonkApiCircuit`) and a
`lookup_any` into a fixed column (`LookupAnyCircuit`).  Used by
`chip_smoke.py` and the tests."""

from __future__ import annotations

import numpy as np

from halo2_tpu_torch.circuit import Cell
from halo2_tpu_torch.fields.bn254 import FR_MODULUS, FR_ZETA
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


class BlockMulChainCircuit(Circuit):
    """MulChainCircuit's chain x_{i+1} = x_i * b, a step a row, split into
    `blocks` regions that `layouter.assign_regions` hands to forked
    workers (plonk/parallel_synthesis.py) when it proves.  Prove it with
    FlatFloorPlanner: every offset is an absolute row.

    Rows 0-1 are a region of their own, assigned before the fan-out:
    x_0 = a at row 0 times the constant 7 (assign_advice_from_constant,
    which a parallel region may not use), x_1 at row 1.  Block j takes rows
    [s_j, s_j + L_j]: a step a row (the selector on, x in a0, b in a1) and
    its last product in a0 at row s_j + L_j.  Its start value x_1 *
    b^(steps before it) comes from `pow`, so no block waits for another.
    A last region copies each block's first cell to the last cell of the
    block before it (the first block's to row 1), and the last product is
    the instance.  Every x past the first few dozen steps is a field
    element of 2^64 or more, so column a0 reaches the prover through the
    overflow merge and the host codec; a1 holds b, a machine int, in
    shared memory.  `a` must stay below 2^61, so that the first region
    leaves a0 a u64 column and the blocks may fan out.

    The closures use nothing but the region they are handed, so the JAX
    package proves this very class (tests/data/gen_torch_golden.py)."""

    def __init__(self, steps: int, blocks: int, a=None, b=None,
                 workers=None):
        if steps < blocks or blocks < 1:
            raise ValueError("need at least one step a block")
        self.steps, self.blocks = steps, blocks
        self.a, self.b = a, b
        self.workers = workers

    def without_witnesses(self):
        return BlockMulChainCircuit(self.steps, self.blocks,
                                    workers=self.workers)

    def configure(self, meta):
        return _configure_mul(meta)

    @staticmethod
    def steps_for(k: int, blocks: int, fill: float = 0.95) -> int:
        """The steps after the first that make the circuit assign `fill`
        of the usable rows of a 2^k-row domain (the first region's two
        rows, and one row a block for its last product, included)."""
        from halo2_tpu_torch.plonk.circuit import ConstraintSystem
        cs = ConstraintSystem()
        _configure_mul(cs)
        return int(cs.usable_rows(1 << k) * fill) - 2 - blocks

    def rows_used(self) -> int:
        return 2 + self.steps + self.blocks

    def layout(self) -> list:
        """(first row, steps, steps before it) of each block."""
        out, row, done = [], 2, 1
        for j in range(self.blocks):
            length = self.steps // self.blocks \
                + (1 if j < self.steps % self.blocks else 0)
            out.append((row, length, done))
            row += length + 1
            done += length
        return out

    def expected_out(self) -> int:
        return self.a * 7 * pow(self.b, self.steps, P) % P

    def synthesize(self, config, layouter):
        a, b = self.a, self.b
        x1 = None if a is None else a * 7 % P

        def start(region):
            region.enable_selector("s", config.s_mul, 0)
            region.assign_advice("x", config.a0, 0, a)
            region.assign_advice_from_constant("seven", config.a1, 0, 7)
            return region.assign_advice("x7", config.a0, 1, x1)
        first_out = layouter.assign_region("start", start)

        def block(row, length, before):
            def fn(region):
                x = None if x1 is None else x1 * pow(b, before - 1, P) % P
                first = None
                for i in range(length):
                    region.enable_selector("s", config.s_mul, row + i)
                    cell = region.assign_advice("x", config.a0, row + i, x)
                    region.assign_advice("b", config.a1, row + i, b)
                    first = first or cell
                    x = None if x is None else x * b % P
                return first, region.assign_advice(
                    "xb", config.a0, row + length, x)
            return fn

        ends = layouter.assign_regions(
            "blocks", [block(*at) for at in self.layout()],
            workers=self.workers)

        def links(region):
            prev = first_out
            for first, last in ends:
                region.constrain_equal(first.cell, prev.cell)
                prev = last
            return prev
        last = layouter.assign_region("links", links)
        layouter.constrain_instance(last.cell, config.instance, 0)


class _LookupShuffleConfig:
    def __init__(self, a, b, tc):
        self.a, self.b, self.tc = a, b, tc


class LookupShuffleCircuit(Circuit):
    """Advice a, b: both looked up in one fixed table through ONE shared
    logup (two input sets: set chunking and z chaining); b must be a
    shuffle of a; one copy constraint a[0] == b[last]."""

    TABLE = list(range(10))
    VALS_A = [3, 1, 4, 1, 5, 9, 2, 6]
    VALS_B = [6, 2, 9, 5, 1, 4, 1, 3]  # a permutation of VALS_A

    def __init__(self, vals_a=None, vals_b=None):
        self.vals_a = vals_a
        self.vals_b = vals_b

    def without_witnesses(self):
        return LookupShuffleCircuit()

    def configure(self, meta):
        a = meta.advice_column()
        b = meta.advice_column()
        tc = meta.table_column()
        meta.enable_equality(a)
        meta.enable_equality(b)
        # both lookups share the table -> merged into one logup argument;
        # the degree forces the second input into an extra set
        meta.lookup("a_range", lambda m: [(m.query_advice(a, 0), tc)])
        meta.lookup("b_range", lambda m: [(m.query_advice(b, 0), tc)])
        meta.shuffle("ab_shuffle",
                     lambda m: [(m.query_advice(a, 0), m.query_advice(b, 0))])
        return _LookupShuffleConfig(a, b, tc)

    def synthesize(self, config, layouter):
        def table_fn(region):
            for i, v in enumerate(self.TABLE):
                region.assign_fixed("t", config.tc.inner, i, v)
        layouter.assign_table("table", table_fn)

        va = self.vals_a or [None] * len(self.VALS_A)
        vb = self.vals_b or [None] * len(self.VALS_B)

        def vals_fn(region):
            cells_a, cells_b = [], []
            for i in range(len(va)):
                cells_a.append(region.assign_advice("a", config.a, i, va[i]))
                cells_b.append(region.assign_advice("b", config.b, i, vb[i]))
            region.constrain_equal(cells_a[0].cell, cells_b[-1].cell)
            return cells_a, cells_b
        layouter.assign_region("vals", vals_fn)


class _RangeCheckConfig:
    def __init__(self, origin, l0, lact, llast):
        self.origin = origin
        self.l0, self.lact, self.llast = l0, lact, llast


class RangeCheckCircuit(Circuit):
    """One advice column range-checked to [MIN, MAX] by a sorted column
    (the prover fills its tail with MIN..MAX and sorts it); the three fixed
    indicator columns mark the first, the usable and the last usable row of
    a 2^k-row domain with `usable` usable rows."""

    MIN, MAX, STEP = 0, 7, 1
    VALUES = [3, 5, 7, 1, 0, 2]

    def __init__(self, values=None, usable: int = 26):
        self.values = values
        self.usable = usable

    def without_witnesses(self):
        return RangeCheckCircuit(usable=self.usable)

    def configure(self, meta):
        l0 = meta.fixed_column()
        lact = meta.fixed_column()
        llast = meta.fixed_column()
        origin = meta.advice_column_range(l0, lact, llast, self.MIN,
                                          self.MAX, self.STEP)
        return _RangeCheckConfig(origin, l0, lact, llast)

    def synthesize(self, config, layouter):
        vals = self.values or [None] * len(self.VALUES)

        def fn(region):
            region.assign_fixed("l0", config.l0, 0, 1)
            for r in range(self.usable):
                region.assign_fixed("lact", config.lact, r, 1)
            region.assign_fixed("llast", config.llast, self.usable - 1, 1)
            for i, v in enumerate(vals):
                region.assign_advice("v", config.origin, i, v)
        layouter.assign_region("rc", fn)


class _AllArgsConfig:
    def __init__(self, a, b, sh, rc_origin, tc, s_sq, l0, lact, llast, inst):
        self.a, self.b, self.sh = a, b, sh
        self.rc_origin, self.tc = rc_origin, tc
        self.s_sq = s_sq
        self.l0, self.lact, self.llast = l0, lact, llast
        self.inst = inst


class AllArgsCircuit(Circuit):
    """Every argument in one proof, over `rows` rows (the usable rows of
    the domain; prove it with FlatFloorPlanner, whose offsets are absolute:
    the range check's indicator columns are tied to the global rows 0 and
    rows - 1).

    a[i] in [0, 16); gate s * (a * a - b); a and b both logup-checked
    against the 0..255 table (a shared table: one argument, two chunked
    input sets); sh is a reversal-shuffle of a; rc_origin range-checked to
    [0, 255] by the sorted-column argument; a[0] == a[1] by a copy, and
    a[0] is the instance.  The witness comes from
    numpy.random.RandomState(seed)."""

    TABLE_BITS = 8
    RC_MAX = 255

    def __init__(self, rows=None, seed=5):
        self.rows = rows
        self.seed = seed

    def without_witnesses(self):
        return AllArgsCircuit(self.rows, self.seed)

    @staticmethod
    def usable_rows(k: int) -> int:
        """The usable rows of a 2^k-row domain for this circuit."""
        from halo2_tpu_torch.plonk.circuit import ConstraintSystem
        cs = ConstraintSystem()
        AllArgsCircuit(1).configure(cs)
        cs.chunk_lookups()
        cs.chunk_shuffles()
        return cs.usable_rows(1 << k)

    def instance(self) -> int:
        """a[0], the public input: the first draw of the witness's stream."""
        return int(np.random.RandomState(self.seed).randint(0, 16, size=1)[0])

    def configure(self, meta):
        a = meta.advice_column()
        b = meta.advice_column()
        sh = meta.advice_column()
        inst = meta.instance_column()
        for c in (a, inst):
            meta.enable_equality(c)
        tc = meta.table_column()
        l0 = meta.fixed_column()
        lact = meta.fixed_column()
        llast = meta.fixed_column()
        s_sq = meta.selector()

        def sq_gate(m):
            return [("sq", m.query_selector(s_sq)
                     * (m.query_advice(a, 0) * m.query_advice(a, 0)
                        - m.query_advice(b, 0)))]

        meta.create_gate("square", sq_gate)
        meta.lookup("a_range", lambda m: [(m.query_advice(a, 0), tc)])
        meta.lookup("b_range", lambda m: [(m.query_advice(b, 0), tc)])
        meta.shuffle("a_rev", lambda m: [
            (m.query_advice(a, 0), m.query_advice(sh, 0))])
        rc_origin = meta.advice_column_range(l0, lact, llast, 0, self.RC_MAX,
                                             1)
        return _AllArgsConfig(a, b, sh, rc_origin, tc, s_sq, l0, lact, llast,
                              inst)

    def synthesize(self, config, layouter):
        rows = self.rows
        rs = np.random.RandomState(self.seed)
        a_vals = rs.randint(0, 16, size=rows).astype(np.int64)
        a_vals[1] = a_vals[0]  # a real copy constraint below
        b_vals = a_vals * a_vals
        sh_vals = a_vals[::-1].copy()
        # the prover fills the tail of the origin column with the full
        # [0, RC_MAX] step sequence: leave room for it
        rc_count = max(min(rows // 2, rows - (self.RC_MAX + 1) - 8), 1)
        rc_vals = rs.randint(0, self.RC_MAX + 1, size=rc_count).astype(
            np.int64)

        def table_fn(region):
            for i in range(1 << self.TABLE_BITS):
                region.assign_fixed("t", config.tc.inner, i, i)
        layouter.assign_table("table", table_fn)

        def fn(region):
            region.assign_fixed("l0", config.l0, 0, 1)
            for r in range(rows):
                region.assign_fixed("lact", config.lact, r, 1)
            region.assign_fixed("llast", config.llast, rows - 1, 1)
            for i in range(rows):
                region.enable_selector("s", config.s_sq, i)
            region.assign_advice_bulk("a", config.a, 0, a_vals)
            region.assign_advice_bulk("b", config.b, 0, b_vals)
            region.assign_advice_bulk("sh", config.sh, 0, sh_vals)
            region.assign_advice_bulk("rc", config.rc_origin, 0, rc_vals)
            region.constrain_equal(Cell(config.a, 0), Cell(config.a, 1))
        layouter.assign_region("body", fn)
        layouter.constrain_instance(Cell(config.a, 0), config.inst, 0)


class _PlonkApiConfig:
    def __init__(self, a, b, c, d, e, sa, sb, sc, sm, sp, sl):
        self.a, self.b, self.c, self.d, self.e = a, b, c, d, e
        self.sa, self.sb, self.sc, self.sm, self.sp = sa, sb, sc, sm, sp
        self.sl = sl


class PlonkApiCircuit(Circuit):
    """The reference's integration spec circuit (tests/plonk_api.rs): a
    combined add-mult gate with a rotated product term, a public-input
    gate, a lookup into a four-entry table, copy constraints; the
    StandardCs chip's regions ten times over.  Column allocation order
    shapes the pinned vk and is kept."""

    A_VALUE = 2834758237 * FR_ZETA % P
    INSTANCE = 2
    LOOKUP_TABLE = [INSTANCE, A_VALUE, A_VALUE, 0]

    def __init__(self, a=None, lookup_table=None):
        self.a = a
        self.lookup_table = list(self.LOOKUP_TABLE if lookup_table is None
                                 else lookup_table)

    def without_witnesses(self):
        return PlonkApiCircuit(None, self.lookup_table)

    def configure(self, meta):
        e = meta.advice_column()
        a = meta.advice_column()
        b = meta.advice_column()
        sf = meta.fixed_column()
        c = meta.advice_column()
        d = meta.advice_column()
        p = meta.instance_column()
        for col in (a, b, c):
            meta.enable_equality(col)
        sm = meta.fixed_column()
        sa = meta.fixed_column()
        sb = meta.fixed_column()
        sc = meta.fixed_column()
        sp = meta.fixed_column()
        sl = meta.table_column()

        meta.lookup("lookup", lambda m: [(m.query_advice(a, 0), sl)])

        def combined_gate(m):
            d_n = m.query_advice(d, 1)
            a_c = m.query_advice(a, 0)
            sf_c = m.query_fixed(sf, 0)
            e_p = m.query_advice(e, -1)
            b_c = m.query_advice(b, 0)
            c_c = m.query_advice(c, 0)
            sa_c = m.query_fixed(sa, 0)
            sb_c = m.query_fixed(sb, 0)
            sc_c = m.query_fixed(sc, 0)
            sm_c = m.query_fixed(sm, 0)
            return [("", a_c * sa_c + b_c * sb_c + a_c * b_c * sm_c
                     - (c_c * sc_c) + sf_c * (d_n * e_p))]

        meta.create_gate("Combined add-mult", combined_gate)

        def public_gate(m):
            a_c = m.query_advice(a, 0)
            p_c = m.query_instance(p, 0)
            sp_c = m.query_fixed(sp, 0)
            return [("", sp_c * (a_c - p_c))]

        meta.create_gate("Public input", public_gate)
        for col in (sf, e, d, p, sm, sa, sb, sc, sp):
            meta.enable_equality(col)
        return _PlonkApiConfig(a, b, c, d, e, sa, sb, sc, sm, sp, sl)

    def _row(self, layouter, name, a, b, c, fixed):
        """One StandardCs row: a, a^4, b, b^4, c and the selectors
        (sa, sb, sc, sm) = fixed; returns the cells of a, b, c."""
        cfg = self._config

        def fn(region):
            lhs = region.assign_advice("lhs", cfg.a, 0, a)
            region.assign_advice("lhs^4", cfg.d, 0,
                                 None if a is None else pow(a, 4, P))
            rhs = region.assign_advice("rhs", cfg.b, 0, b)
            region.assign_advice("rhs^4", cfg.e, 0,
                                 None if b is None else pow(b, 4, P))
            out = region.assign_advice("out", cfg.c, 0, c)
            for col, v in zip((cfg.sa, cfg.sb, cfg.sc, cfg.sm), fixed):
                region.assign_fixed("s", col, 0, v)
            return lhs.cell, rhs.cell, out.cell
        return layouter.assign_region(name, fn)

    def _copy(self, layouter, left, right):
        def fn(region):
            region.constrain_equal(left, right)
            region.constrain_equal(left, right)
        layouter.assign_region("copy", fn)

    def synthesize(self, config, layouter):
        self._config = config
        a = self.a

        def public_input(region):
            cell = region.assign_advice("value", config.a, 0, 2)
            region.assign_fixed("public", config.sp, 0, 1)
            return cell.cell
        layouter.assign_region("public_input", public_input)
        a_sq = None if a is None else a * a % P
        fin = None if a is None else (a + a_sq) % P
        for _ in range(10):
            a0, _, c0 = self._row(layouter, "raw_multiply", a, a, a_sq,
                                  (0, 0, 1, 1))
            a1, b1, _ = self._row(layouter, "raw_add", a, a_sq, fin,
                                  (1, 1, 1, 0))
            self._copy(layouter, a0, a1)
            self._copy(layouter, b1, c0)

        def table(region):
            for index, value in enumerate(self.lookup_table):
                region.assign_fixed("table col", config.sl.inner, index,
                                    value)
        layouter.assign_table("", table)


class LookupAnyCircuit(Circuit):
    """One advice column looked up in one fixed column (`lookup_any`): the
    fixed column holds TABLE, the advice column `values` (0, which is in
    the table, elsewhere)."""

    TABLE = [0, 1, 2, 3, 4, 5, 6, 7]
    VALUES = [3, 1, 4, 1, 5, 7, 2, 6]

    def __init__(self, values=None):
        self.values = values

    def without_witnesses(self):
        return LookupAnyCircuit()

    def configure(self, meta):
        a = meta.advice_column()
        t = meta.fixed_column()
        meta.lookup_any("in_table", lambda m: [(m.query_advice(a, 0),
                                                m.query_fixed(t, 0))])
        return a, t

    def synthesize(self, config, layouter):
        a, t = config
        values = self.values or [None] * len(self.VALUES)

        def fn(region):
            for row, v in enumerate(self.TABLE):
                region.assign_fixed("t", t, row, v)
            for row, v in enumerate(values):
                region.assign_advice("a", a, row, v)
        layouter.assign_region("lookup_any", fn)
