"""Circuit frontend: columns, expressions, gates, ConstraintSystem.

Python re-design of halo2_proofs/src/plonk/circuit.rs
(2022 LoC) with the same semantics:
  * `Column` of advice/fixed/instance with deterministic ordering
  * `Expression` AST (Constant / queries / Negated / Sum / Product / Scaled)
    with `degree()` and closure-style `evaluate` (circuit.rs:453-921)
  * query deduplication per (column, rotation) (circuit.rs query_*_index)
  * `ConstraintSystem` with gates, equality-enabled columns (the permutation
    argument), degree / blinding_factors / minimum_rows (circuit.rs:1862-1956)

Selectors follow the reference design: `Selector`s are VIRTUAL during
configure (`query_selector` returns an Expression.Selector node), and
keygen packs them into combination fixed columns via `compress_selectors`
below (the exclusion-matrix packer, mirroring circuit.rs:1603-1734 +
compress_selectors.rs), substituting each selector expression with the
combination-column polynomial.  `enable_selector` records activations in
the assembly; the packed fixed columns are appended after synthesis
(keygen.py).

Field values are canonical Python ints mod Fr.p at this layer; the device
limb encoding happens in keygen/prover.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.plonk import logup as logup_mod
from halo2_tpu_torch.plonk import shuffle as shuffle_mod
from halo2_tpu_torch.plonk.range_check import RangeCheckRel

P = FR_MODULUS


class Rotation(int):
    """Query rotation (offset in rows, relative to the current row)."""

    @staticmethod
    def cur() -> "Rotation":
        return Rotation(0)

    @staticmethod
    def next() -> "Rotation":
        return Rotation(1)

    @staticmethod
    def prev() -> "Rotation":
        return Rotation(-1)


_CTYPE_ORDER = {"instance": 0, "advice": 1, "fixed": 2}


@dataclass(frozen=True, order=False)
class Column:
    index: int
    ctype: str  # "advice" | "fixed" | "instance"

    def __lt__(self, other):
        return (_CTYPE_ORDER[self.ctype], self.index) < (
            _CTYPE_ORDER[other.ctype], other.index)

    def __repr__(self):
        return f"{self.ctype[0].upper()}{self.index}"


@dataclass(frozen=True)
class TableColumn:
    """A fixed column managed as a lookup table (circuit.rs:279-295)."""
    inner: Column


@dataclass(frozen=True)
class Selector:
    """A virtual selector (circuit.rs:253-267).

    Selectors carry no column at creation; `ConstraintSystem.
    compress_selectors` (the reference's circuit.rs:1603-1734 +
    circuit/compress_selectors.rs) packs disjoint simple selectors into
    shared fixed "combination" columns during keygen and substitutes every
    `SelectorExpr` in gates/lookups/shuffles with a fixed-query expression.
    """
    index: int
    is_simple: bool = True


# ---------------------------------------------------------------------------
# Expression AST
# ---------------------------------------------------------------------------

class Expression:
    def degree(self) -> int:
        raise NotImplementedError

    # operators -----------------------------------------------------------
    def __add__(self, other):
        return Sum(self, _coerce(other))

    def __radd__(self, other):
        return Sum(_coerce(other), self)

    def __sub__(self, other):
        return Sum(self, Negated(_coerce(other)))

    def __rsub__(self, other):
        return Sum(_coerce(other), Negated(self))

    def __neg__(self):
        return Negated(self)

    def __mul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other % P)
        return Product(self, _coerce(other))

    def __rmul__(self, other):
        return self.__mul__(other)

    def evaluate(self, constant, fixed_q, advice_q, instance_q,
                 negated, sum_, product, scaled):
        """Closure-style fold, mirroring Expression::evaluate
        (circuit.rs:606-700)."""
        raise NotImplementedError

    def identifier(self) -> str:
        raise NotImplementedError

    def evaluate_lazy(self, constant, fixed_q, advice_q, instance_q,
                      negated, sum_, product, scaled, zero):
        """Closure fold with the multiplication short-circuit: if one side
        of a Product evaluates to `zero`, the other side is NOT evaluated
        (Expression::evaluate_lazy, circuit.rs:703-787).  `zero` is the
        caller's zero representative, compared with ==."""
        h = (constant, fixed_q, advice_q, instance_q, negated, sum_,
             product, scaled)
        if isinstance(self, Product):
            a = self.a.evaluate_lazy(*h, zero)
            if a == zero:
                return a
            return product(a, self.b.evaluate_lazy(*h, zero))
        if isinstance(self, Sum):
            return sum_(self.a.evaluate_lazy(*h, zero),
                        self.b.evaluate_lazy(*h, zero))
        if isinstance(self, Negated):
            return negated(self.expr.evaluate_lazy(*h, zero))
        if isinstance(self, Scaled):
            return scaled(self.expr.evaluate_lazy(*h, zero), self.scalar)
        return self.evaluate(*h)

    def complexity(self) -> int:
        """Approximate evaluation cost (Expression::complexity,
        circuit.rs:820-860): queries cost 1, add 15, mul 30, scale 30."""
        if isinstance(self, Constant):
            return 0
        if isinstance(self, (SelectorExpr, FixedQuery, AdviceQuery,
                             InstanceQuery)):
            return 1
        if isinstance(self, Negated):
            return self.expr.complexity() + 5
        if isinstance(self, Sum):
            return self.a.complexity() + self.b.complexity() + 15
        if isinstance(self, Product):
            return self.a.complexity() + self.b.complexity() + 30
        if isinstance(self, Scaled):
            return self.expr.complexity() + 30
        raise TypeError(type(self))


def _coerce(v) -> Expression:
    if isinstance(v, Expression):
        return v
    if isinstance(v, int):
        return Constant(v % P)
    raise TypeError(f"cannot use {type(v)} in an Expression")


@dataclass(frozen=True)
class Constant(Expression):
    value: int

    def degree(self):
        return 0

    def evaluate(self, constant, *rest):
        return constant(self.value)

    def identifier(self):
        return f"c{self.value}"


@dataclass(frozen=True)
class SelectorExpr(Expression):
    """A virtual-selector query (Expression::Selector).  Must be substituted
    by `compress_selectors` before any evaluation — only `degree` and
    `identifier` are meaningful pre-substitution."""
    selector: Selector

    def degree(self):
        return 1

    def evaluate(self, *h):
        raise RuntimeError(
            "virtual selector evaluated — run compress_selectors first")

    def identifier(self):
        return f"selector[{self.selector.index}]"


@dataclass(frozen=True)
class FixedQuery(Expression):
    query_index: int
    column_index: int
    rotation: int

    def degree(self):
        return 1

    def evaluate(self, constant, fixed_q, *rest):
        return fixed_q(self)

    def identifier(self):
        return f"fixed[{self.column_index}][{self.rotation}]"


@dataclass(frozen=True)
class AdviceQuery(Expression):
    query_index: int
    column_index: int
    rotation: int

    def degree(self):
        return 1

    def evaluate(self, constant, fixed_q, advice_q, *rest):
        return advice_q(self)

    def identifier(self):
        return f"advice[{self.column_index}][{self.rotation}]"


@dataclass(frozen=True)
class InstanceQuery(Expression):
    query_index: int
    column_index: int
    rotation: int

    def degree(self):
        return 1

    def evaluate(self, constant, fixed_q, advice_q, instance_q, *rest):
        return instance_q(self)

    def identifier(self):
        return f"instance[{self.column_index}][{self.rotation}]"


@dataclass(frozen=True)
class Negated(Expression):
    expr: Expression

    def degree(self):
        return self.expr.degree()

    def evaluate(self, constant, fixed_q, advice_q, instance_q,
                 negated, sum_, product, scaled):
        return negated(self.expr.evaluate(
            constant, fixed_q, advice_q, instance_q, negated, sum_, product,
            scaled))

    def identifier(self):
        return f"(-{self.expr.identifier()})"


@dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def evaluate(self, *h):
        return h[5](self.a.evaluate(*h), self.b.evaluate(*h))

    def identifier(self):
        return f"({self.a.identifier()}+{self.b.identifier()})"


@dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return self.a.degree() + self.b.degree()

    def evaluate(self, *h):
        return h[6](self.a.evaluate(*h), self.b.evaluate(*h))

    def identifier(self):
        return f"({self.a.identifier()}*{self.b.identifier()})"


@dataclass(frozen=True)
class Scaled(Expression):
    expr: Expression
    scalar: int

    def degree(self):
        return self.expr.degree()

    def evaluate(self, *h):
        return h[7](self.expr.evaluate(*h), self.scalar)

    def identifier(self):
        return f"({self.expr.identifier()}*s{self.scalar})"


def extract_simple_selector(expr: Expression):
    """The unique simple selector inside expr, or None
    (Expression::extract_simple_selector; two simple selectors in one
    expression is a construction error)."""
    if isinstance(expr, SelectorExpr):
        return expr.selector if expr.selector.is_simple else None
    if isinstance(expr, Negated):
        return extract_simple_selector(expr.expr)
    if isinstance(expr, Scaled):
        return extract_simple_selector(expr.expr)
    if isinstance(expr, (Sum, Product)):
        a = extract_simple_selector(expr.a)
        b = extract_simple_selector(expr.b)
        if a is not None and b is not None:
            raise ValueError(
                "two simple selectors cannot be in the same expression")
        return a if a is not None else b
    return None


def replace_selectors(expr: Expression, replacements: list,
                      must_be_nonsimple: bool) -> Expression:
    """Substitute every SelectorExpr with its combination expression
    (circuit.rs:1666-1703).  Rebuilds the tree with the same node shapes the
    reference produces, so the pinned CS string matches byte-for-byte."""
    if isinstance(expr, SelectorExpr):
        if must_be_nonsimple:
            assert not expr.selector.is_simple, \
                "simple selectors may not appear in lookup/shuffle inputs"
        return replacements[expr.selector.index]
    if isinstance(expr, Negated):
        return Negated(replace_selectors(expr.expr, replacements,
                                         must_be_nonsimple))
    if isinstance(expr, Sum):
        return Sum(replace_selectors(expr.a, replacements, must_be_nonsimple),
                   replace_selectors(expr.b, replacements, must_be_nonsimple))
    if isinstance(expr, Product):
        return Product(
            replace_selectors(expr.a, replacements, must_be_nonsimple),
            replace_selectors(expr.b, replacements, must_be_nonsimple))
    if isinstance(expr, Scaled):
        return Scaled(replace_selectors(expr.expr, replacements,
                                        must_be_nonsimple), expr.scalar)
    return expr


def eval_expression_host(expr: Expression, fixed, advice, instance) -> int:
    """Evaluate with host int lookups fixed/advice/instance: fn(query)->int."""
    return expr.evaluate(
        lambda c: c,
        fixed, advice, instance,
        lambda a: (-a) % P,
        lambda a, b: (a + b) % P,
        lambda a, b: a * b % P,
        lambda a, s: a * s % P,
    )


# ---------------------------------------------------------------------------
# Gates & permutation argument descriptor
# ---------------------------------------------------------------------------

@dataclass
class Gate:
    name: str
    polys: list  # list[Expression]
    constraint_names: list


@dataclass
class PermutationArgument:
    """Equality-enabled columns (plonk/permutation.rs:29-62)."""
    columns: list = field(default_factory=list)

    def required_degree(self) -> int:
        return 3

    def add_column(self, column: Column):
        if column not in self.columns:
            self.columns.append(column)


# ---------------------------------------------------------------------------
# ConstraintSystem
# ---------------------------------------------------------------------------

class ConstraintSystem:
    def __init__(self):
        self.num_fixed_columns = 0
        self.num_advice_columns = 0
        self.num_instance_columns = 0
        self.num_selectors = 0
        self.selectors: list[Selector] = []
        self.selector_map: list[Column] = []  # filled by compress_selectors
        self.gates: list[Gate] = []
        self.advice_queries: list[tuple[Column, int]] = []
        self.num_advice_queries: list[int] = []
        self.fixed_queries: list[tuple[Column, int]] = []
        self.instance_queries: list[tuple[Column, int]] = []
        self.permutation = PermutationArgument()
        self.lookups: list = []              # chunked logup arguments
        self.lookup_tracers: dict = {}       # table_identifier -> ArgumentTracer
        self.shuffles: list = []             # chunked shuffle groups
        self.shuffle_tracer: list = []       # flat shuffle units
        self.range_check: list = []          # RangeCheckRel entries
        self.constants: list[Column] = []
        self.named_advices: list[int] = []   # advice column indices exempt
                                             # from blinding (circuit.rs:1840)
        self.minimum_degree: int | None = None

    # -- column allocation -------------------------------------------------
    def advice_column(self) -> Column:
        c = Column(self.num_advice_columns, "advice")
        self.num_advice_columns += 1
        self.num_advice_queries.append(0)
        return c

    def named_advice_column(self, name: str) -> Column:
        """Advice column exempt from blinding rows (the fork's API for
        columns whose tail is structurally constrained,
        circuit.rs:1840-1850)."""
        c = self.advice_column()
        self.named_advices.append(c.index)
        return c

    def fixed_column(self) -> Column:
        c = Column(self.num_fixed_columns, "fixed")
        self.num_fixed_columns += 1
        return c

    def instance_column(self) -> Column:
        c = Column(self.num_instance_columns, "instance")
        self.num_instance_columns += 1
        return c

    def table_column(self) -> TableColumn:
        return TableColumn(self.fixed_column())

    def selector(self) -> Selector:
        s = Selector(self.num_selectors, is_simple=True)
        self.num_selectors += 1
        self.selectors.append(s)
        return s

    def complex_selector(self) -> Selector:
        s = Selector(self.num_selectors, is_simple=False)
        self.num_selectors += 1
        self.selectors.append(s)
        return s

    # -- selector compression (circuit.rs:1603-1734 + compress_selectors.rs)
    def compress_selectors(self, selectors: list) -> list:
        """Pack selector activation vectors into shared fixed columns.

        selectors: one bool list (length n) per selector, in selector-index
        order.  Allocates the combination fixed columns, substitutes every
        SelectorExpr in gates/lookups/shuffles, fills `selector_map`, and
        returns the combination columns' value lists (ints, one per new
        fixed column, in allocation order).  Call exactly once, after
        configure+chunking and before committing fixed columns."""
        assert len(selectors) == self.num_selectors
        assert not getattr(self, "_selectors_compressed", False), \
            "compress_selectors called twice"
        self._selectors_compressed = True

        # max degree over gates of each simple selector (degree 0 = complex
        # or unused — gets its own concrete column)
        degrees = [0] * len(selectors)
        for gate in self.gates:
            for expr in gate.polys:
                sel = extract_simple_selector(expr)
                if sel is not None:
                    degrees[sel.index] = max(degrees[sel.index], expr.degree())
        max_degree = self.degree()

        new_columns: list[Column] = []

        def allocate_fixed_column() -> Expression:
            column = self.fixed_column()
            new_columns.append(column)
            return FixedQuery(self.query_fixed_index(column, 0),
                              column.index, 0)

        combination_assignments: list[list[int]] = []
        replacements: list = [None] * len(selectors)
        combo_of: list = [None] * len(selectors)

        # degree-0 (complex / unused) selectors: direct 0/1 columns
        simple: list[int] = []
        for i, activations in enumerate(selectors):
            if degrees[i] == 0:
                expr = allocate_fixed_column()
                combination_assignments.append(
                    [1 if b else 0 for b in activations])
                replacements[i] = expr
                combo_of[i] = len(combination_assignments) - 1
            else:
                simple.append(i)

        # exclusion matrix over the remaining (simple) selectors
        def conflicts(i, j):
            ai, aj = selectors[i], selectors[j]
            return any(l and r for l, r in zip(ai, aj))

        added = {i: False for i in simple}
        for pos, i in enumerate(simple):
            if added[i]:
                continue
            added[i] = True
            assert degrees[i] <= max_degree
            d = degrees[i] - 1  # omit the virtual selector itself
            combination = [i]
            for j in simple[pos + 1:]:
                if d + len(combination) == max_degree:
                    break
                if added[j]:
                    continue
                if any(conflicts(j, k) for k in combination):
                    continue
                new_d = max(d, degrees[j] - 1)
                if new_d + len(combination) + 1 > max_degree:
                    continue
                d = new_d
                combination.append(j)
                added[j] = True

            n = len(selectors[combination[0]])
            combination_assignment = [0] * n
            combination_len = len(combination)
            combination_index = len(combination_assignments)
            query = allocate_fixed_column()

            assigned_root = 1
            for i2 in combination:
                # q * prod_{root != assigned_root} (root - q): nonzero only
                # on rows where the combination column equals assigned_root
                expression = query
                root = 1
                for _ in range(combination_len):
                    if root != assigned_root:
                        expression = expression * (Constant(root % P) - query)
                    root += 1
                for r, b in enumerate(selectors[i2]):
                    if b:
                        combination_assignment[r] = assigned_root
                assigned_root += 1
                replacements[i2] = expression
                combo_of[i2] = combination_index
            combination_assignments.append(combination_assignment)

        self.selector_map = [new_columns[combo_of[i]]
                             for i in range(len(selectors))]

        for gate in self.gates:
            gate.polys = [replace_selectors(p, replacements, False)
                          for p in gate.polys]
        for lk in self.lookups:
            lk.table_expressions = [
                replace_selectors(e, replacements, True)
                for e in lk.table_expressions]
            lk.input_expressions_sets = [
                [[replace_selectors(e, replacements, True) for e in inputs]
                 for inputs in s]
                for s in lk.input_expressions_sets]
        for group in self.shuffles:
            for unit in group.units:
                unit.input_expressions = [
                    replace_selectors(e, replacements, True)
                    for e in unit.input_expressions]
                unit.shuffle_expressions = [
                    replace_selectors(e, replacements, True)
                    for e in unit.shuffle_expressions]
        return combination_assignments

    # -- equality / constants ---------------------------------------------
    def enable_equality(self, column: Column):
        self.query_any_index(column, 0)
        self.permutation.add_column(column)

    def enable_constant(self, column: Column):
        """column must be a fixed column; it becomes a constants sink."""
        assert column.ctype == "fixed"
        if column not in self.constants:
            self.constants.append(column)
            self.enable_equality(column)

    # -- queries -----------------------------------------------------------
    def query_fixed_index(self, column: Column, at: int) -> int:
        for i, (c, rot) in enumerate(self.fixed_queries):
            if c == column and rot == at:
                return i
        self.fixed_queries.append((column, at))
        return len(self.fixed_queries) - 1

    def query_advice_index(self, column: Column, at: int) -> int:
        for i, (c, rot) in enumerate(self.advice_queries):
            if c == column and rot == at:
                return i
        self.advice_queries.append((column, at))
        self.num_advice_queries[column.index] += 1
        return len(self.advice_queries) - 1

    def query_instance_index(self, column: Column, at: int) -> int:
        for i, (c, rot) in enumerate(self.instance_queries):
            if c == column and rot == at:
                return i
        self.instance_queries.append((column, at))
        return len(self.instance_queries) - 1

    def query_any_index(self, column: Column, at: int) -> int:
        if column.ctype == "advice":
            return self.query_advice_index(column, at)
        if column.ctype == "fixed":
            return self.query_fixed_index(column, at)
        return self.query_instance_index(column, at)

    def get_any_query_index(self, column: Column, at: int = 0) -> int:
        queries = {"advice": self.advice_queries, "fixed": self.fixed_queries,
                   "instance": self.instance_queries}[column.ctype]
        for i, (c, rot) in enumerate(queries):
            if c == column and rot == at:
                return i
        raise KeyError(f"no query for {column} at rotation {at}")

    # -- gates --------------------------------------------------------------
    def create_gate(self, name: str, fn):
        """fn(meta: VirtualCells) -> list of (optionally (name, expr))
        constraint expressions."""
        cells = VirtualCells(self)
        constraints = fn(cells)
        polys, names = [], []
        for item in constraints:
            if isinstance(item, tuple):
                cname, expr = item
            else:
                cname, expr = "", item
            polys.append(_coerce(expr))
            names.append(cname)
        if not polys:
            raise ValueError(f"gate {name} has no constraints")
        self.gates.append(Gate(name, polys, names))

    # -- lookups / shuffles --------------------------------------------------
    def lookup(self, name: str, fn):
        """fn(meta) -> list of (input_expr, TableColumn) pairs
        (circuit.rs:1330-1369). Lookups sharing a table merge into one
        logup argument."""
        cells = VirtualCells(self)
        pairs = fn(cells)
        inputs, tables = [], []
        for inp, tbl in pairs:
            assert isinstance(tbl, TableColumn)
            inputs.append(_coerce(inp))
            tables.append(cells.query_fixed(tbl.inner, 0))
        return self._register_lookup(name, inputs, tables)

    def lookup_any(self, name: str, fn):
        """fn(meta) -> list of (input_expr, table_expr) pairs — any column
        type as table (circuit.rs:1375-1406)."""
        cells = VirtualCells(self)
        pairs = fn(cells)
        inputs = [_coerce(i) for i, _ in pairs]
        tables = [_coerce(t) for _, t in pairs]
        return self._register_lookup(name, inputs, tables)

    def _register_lookup(self, name, inputs, tables):
        index = len(self.lookup_tracers)
        tid = "".join(t.identifier() for t in tables)
        tracer = self.lookup_tracers.get(tid)
        if tracer is not None:
            tracer.input_expression_set.append((name, inputs))
        else:
            self.lookup_tracers[tid] = logup_mod.ArgumentTracer(
                name, tables, [(name, inputs)])
        return index

    def shuffle(self, name: str, fn):
        """fn(meta) -> list of (input_expr, shuffle_expr) pairs
        (circuit.rs:1430-1442)."""
        cells = VirtualCells(self)
        pairs = fn(cells)
        inputs = [_coerce(i) for i, _ in pairs]
        shuffles = [_coerce(s) for _, s in pairs]
        index = len(self.shuffle_tracer)
        self.shuffle_tracer.append(
            shuffle_mod.ShuffleUnit(name, inputs, shuffles))
        return index

    def advice_column_range(self, l_0: Column, l_active: Column,
                            l_last_active: Column, min_v: int, max_v: int,
                            step: int) -> Column:
        """Range-checked advice column (circuit.rs:1771-1826): allocates
        origin + sort columns, adds the 3-constraint sort gate and the
        origin<->sort shuffle; the prover fills and sorts automatically.
        l_0 / l_active / l_last_active are user-maintained fixed indicator
        columns (1 at row 0 / on active rows / at the last active row)."""
        origin = self.advice_column()
        sort = self.advice_column()

        def gate(m):
            s_cur = m.query_advice(sort, 0)
            s_next = m.query_advice(sort, 1)
            first = m.query_fixed(l_0, 0) * (Constant(min_v % P) - s_cur)
            last = m.query_fixed(l_last_active, 0) * (Constant(max_v % P) - s_cur)
            prod = None
            for s in range(step + 1):
                term = s_next - s_cur - Constant(s % P)
                prod = term if prod is None else prod * term
            mid = (m.query_fixed(l_active, 0) - m.query_fixed(l_last_active, 0)) * prod
            return [("rc_first", first), ("rc_last", last), ("rc_step", mid)]

        self.create_gate("range check", gate)
        self.shuffle("range check col", lambda m: [
            (m.query_advice(origin, 0), m.query_advice(sort, 0))])
        self.range_check.append(
            RangeCheckRel(origin, sort, min_v, max_v, step))
        return origin

    def chunk_lookups(self):
        """Pack registered lookups by degree — iterate tracers in sorted
        table-identifier order (the reference's BTreeMap order)."""
        if self.lookup_tracers:
            self.lookups = [self.lookup_tracers[tid].chunks(self.degree())
                            for tid in sorted(self.lookup_tracers)]

    def chunk_shuffles(self):
        if self.shuffle_tracer:
            self.shuffles = shuffle_mod.chunk(self.shuffle_tracer, self.degree())

    # -- global properties ---------------------------------------------------
    def degree(self) -> int:
        """Max constraint degree (circuit.rs:1862-1915)."""
        degree = self.permutation.required_degree()
        # tracers (pre-chunk) take precedence, mirroring circuit.rs:1871-1901
        if self.lookup_tracers:
            for tracer in self.lookup_tracers.values():
                degree = max(degree, tracer.required_degree())
        else:
            for lookup in self.lookups:
                degree = max(degree, lookup.required_degree())
        if self.shuffle_tracer:
            for unit in self.shuffle_tracer:
                degree = max(degree, unit.required_degree())
        else:
            for group in self.shuffles:
                for unit in group.units:
                    degree = max(degree, unit.required_degree())
        for gate in self.gates:
            for poly in gate.polys:
                degree = max(degree, poly.degree())
        if self.minimum_degree is not None:
            degree = max(degree, self.minimum_degree)
        return degree

    def blinding_factors(self) -> int:
        """(circuit.rs:1917-1944)"""
        factors = max(self.num_advice_queries) if self.num_advice_queries else 1
        factors = max(3, factors)
        factors += 1  # multiopen
        return factors + 1  # off-by-one defense

    def minimum_rows(self) -> int:
        return self.blinding_factors() + 3

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors() + 1)

    # -- canonical repr for the vk hash -------------------------------------
    def pinned(self) -> str:
        parts = [
            f"fixed={self.num_fixed_columns}",
            f"advice={self.num_advice_columns}",
            f"instance={self.num_instance_columns}",
            "gates=[" + ",".join(
                p.identifier() for g in self.gates for p in g.polys) + "]",
            "advice_queries=" + repr([(c.index, r) for c, r in self.advice_queries]),
            "fixed_queries=" + repr([(c.index, r) for c, r in self.fixed_queries]),
            "instance_queries=" + repr([(c.index, r) for c, r in self.instance_queries]),
            "permutation=" + repr([(c.ctype, c.index) for c in self.permutation.columns]),
            "lookups=[" + ",".join(lk.identifier() for lk in self.lookups) + "]",
            "shuffles=[" + ",".join(sh.identifier() for sh in self.shuffles) + "]",
            "constants=" + repr([c.index for c in self.constants]),
        ]
        return ";".join(parts)


class VirtualCells:
    """Query interface passed to gate closures (circuit.rs:1962-2022)."""

    def __init__(self, cs: ConstraintSystem):
        self._cs = cs

    def query_advice(self, column: Column, at: int = 0) -> Expression:
        idx = self._cs.query_advice_index(column, at)
        return AdviceQuery(idx, column.index, at)

    def query_fixed(self, column: Column, at: int = 0) -> Expression:
        idx = self._cs.query_fixed_index(column, at)
        return FixedQuery(idx, column.index, at)

    def query_instance(self, column: Column, at: int = 0) -> Expression:
        idx = self._cs.query_instance_index(column, at)
        return InstanceQuery(idx, column.index, at)

    def query_selector(self, selector: Selector) -> Expression:
        return SelectorExpr(selector)

    def query_any(self, column: Column, at: int = 0) -> Expression:
        return {"advice": self.query_advice, "fixed": self.query_fixed,
                "instance": self.query_instance}[column.ctype](column, at)


class Circuit:
    """User circuit interface (circuit.rs:431-450)."""

    def configure(self, meta: ConstraintSystem):
        raise NotImplementedError

    def synthesize(self, config, layouter):
        raise NotImplementedError

    def without_witnesses(self) -> "Circuit":
        raise NotImplementedError
