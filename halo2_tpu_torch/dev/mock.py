"""MockProver: the no-crypto debugging backend.

Mirrors halo2_proofs/src/dev.rs (MockProver::run /
verify_at_rows): synthesizes into plain host matrices and re-evaluates every
gate row, permutation cycle, logup, shuffle and range check directly — no
params, no keys, no device.

Fidelity features (dev.rs parity):
  * **Poisoned rows** (dev.rs:340-356, 880-886): advice/fixed cells in the
    unusable tail are CellValue::Poison; gate constraints are also checked
    on the blinding rows, where a poison reaching the constraint output
    yields a "gate_poisoned" failure ("missing selector?") — unless killed
    by multiplication with a concrete zero (dev.rs:385-411).
  * **Located failures** (dev.rs:140-258): every failure is a typed object
    carrying gate/constraint names, the row, and the enclosing region
    (index, name, offset) when one matches.
  * **Selector compression** runs exactly as in keygen (dev.rs compresses
    in MockProver::run as well).
  * **CellNotAssigned** (dev.rs:143-155, 962-999): within each region,
    every cell queried by a gate whose selector is enabled there must be
    assigned.
  * **verify_at_rows** (dev.rs:940): gate/lookup checks restricted to a
    row subset.
  * Permutation failures report the mismatching VALUES (instance-value
    mismatch debugging).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from halo2_tpu_torch.circuit import Assignment, Cell, SimpleFloorPlanner
from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.error import (InvalidInstancesError,
                                   NotEnoughRowsAvailable)

P = FR_MODULUS

POISON = object()  # Value::Poison sentinel


@dataclass
class FailureLocation:
    """dev.rs metadata::FailureLocation: InRegion {region, offset} or
    OutsideRegion {row}."""
    row: int
    region_index: int | None = None
    region_name: str | None = None
    offset: int | None = None

    def __repr__(self):
        if self.region_name is not None:
            return (f"in Region {self.region_index} ('{self.region_name}') "
                    f"at offset {self.offset}")
        return f"outside any region, on row {self.row}"


@dataclass
class VerifyFailure:
    """Typed failure (dev.rs VerifyFailure variants).  kind is one of
    "cell_not_assigned" | "gate" | "gate_poisoned" | "permutation" |
    "lookup" | "shuffle"."""
    kind: str
    detail: str
    gate: str | None = None
    constraint: str | None = None
    location: FailureLocation | None = None
    # cell_not_assigned extras (dev.rs:143-155): the column and the offset
    # relative to the region start (may be negative when a rotation reaches
    # before the region)
    column: tuple | None = None
    offset: int | None = None

    def __repr__(self):
        loc = f" ({self.location})" if self.location is not None else ""
        return f"{self.kind}: {self.detail}{loc}"


@dataclass
class _RegionRecord:
    index: int
    name: str
    rows: list = field(default_factory=lambda: [None, None])  # [min, max]
    columns: set = field(default_factory=set)  # (ctype, index)
    # exact assigned cells (ctype, col_index, row) and per-selector enabled
    # rows — the inputs to the CellNotAssigned check (dev.rs:296-334:
    # Region { enabled_selectors, cells })
    cells: set = field(default_factory=set)
    enabled_selectors: dict = field(default_factory=dict)  # sel_idx -> [rows]

    def note(self, ctype, col_index, row):
        self.columns.add((ctype, col_index))
        self.cells.add((ctype, col_index, row))
        lo, hi = self.rows
        self.rows = [row if lo is None else min(lo, row),
                     row if hi is None else max(hi, row)]

    def is_assigned(self, ctype, col_index, row) -> bool:
        return (ctype, col_index, row) in self.cells


class _MockAssembly(Assignment):
    def __init__(self, cs: ConstraintSystem, n: int, usable_rows: int, instances):
        self.cs = cs
        self.n = n
        self.usable_rows = usable_rows
        self.instance = instances
        self.advice = [[0] * n for _ in range(cs.num_advice_columns)]
        self.fixed = [[0] * n for _ in range(cs.num_fixed_columns)]
        self.selectors = [[False] * n for _ in range(cs.num_selectors)]
        self.copies: list[tuple[Cell, Cell]] = []
        self.regions: list[_RegionRecord] = []
        self._region: _RegionRecord | None = None

    def enter_region(self, name):
        self._region = _RegionRecord(len(self.regions), str(name))
        self.regions.append(self._region)

    def exit_region(self):
        self._region = None

    def _note(self, ctype, index, row):
        if self._region is not None:
            self._region.note(ctype, index, row)

    def enable_selector(self, selector, row):
        self._check(row)
        self.selectors[selector.index][row] = True
        self._note("selector", selector.index, row)
        if self._region is not None:
            self._region.enabled_selectors.setdefault(
                selector.index, []).append(row)

    def assign_advice(self, column, row, value):
        self._check(row)
        if value is not None:
            self.advice[column.index][row] = int(value) % P
        self._note("advice", column.index, row)

    def assign_advice_bulk(self, column, from_row, values):
        if from_row + len(values) > self.usable_rows:
            raise ValueError("not enough rows available")
        col = self.advice[column.index]
        # int() first: numpy scalars raise OverflowError on % with a
        # 254-bit Python-int modulus
        col[from_row: from_row + len(values)] = [int(v) % P for v in values]
        for r in range(from_row, from_row + len(values)):
            self._note("advice", column.index, r)

    def assign_fixed(self, column, row, value):
        self._check(row)
        if value is not None:
            self.fixed[column.index][row] = int(value) % P
        self._note("fixed", column.index, row)

    def copy(self, left, right):
        self.copies.append((left, right))

    def query_instance(self, column, row):
        self._check(row)
        return self.instance[column.index][row]

    def fill_from_row(self, column, from_row, value):
        if value is None:
            return
        for r in range(from_row, self.usable_rows):
            self.fixed[column.index][r] = int(value) % P

    def _check(self, row):
        if row >= self.usable_rows:
            raise ValueError(f"row {row} exceeds usable rows {self.usable_rows}")

    # -- cell access with poison semantics (dev.rs:340-356) ----------------
    def cell_value(self, column, row: int):
        """ADVICE cells on unusable rows are POISON (dev.rs:880-886 poisons
        only advice — "fixed columns contain no blinding factors"); fixed
        and instance cells are always real, unassigned defaulting to zero
        (dev.rs:350-358)."""
        row %= self.n
        if column.ctype == "instance":
            return self.instance[column.index][row]
        if column.ctype == "advice":
            if row >= self.usable_rows:
                return POISON
            return self.advice[column.index][row]
        return self.fixed[column.index][row]


def _eval_poison(expr, fixed, advice, instance):
    """Expression evaluation over Value = int | POISON, with the reference's
    poison-times-zero short circuit (dev.rs:385-411)."""
    from halo2_tpu_torch.plonk import circuit as cir

    def ev(e):
        if isinstance(e, cir.Constant):
            return e.value
        if isinstance(e, cir.FixedQuery):
            return fixed(e)
        if isinstance(e, cir.AdviceQuery):
            return advice(e)
        if isinstance(e, cir.InstanceQuery):
            return instance(e)
        if isinstance(e, cir.Negated):
            v = ev(e.expr)
            return POISON if v is POISON else (-v) % P
        if isinstance(e, cir.Sum):
            a, b = ev(e.a), ev(e.b)
            if a is POISON or b is POISON:
                return POISON
            return (a + b) % P
        if isinstance(e, cir.Product):
            a, b = ev(e.a), ev(e.b)
            if a is POISON and b is POISON:
                return POISON
            if a is POISON:
                return 0 if b == 0 else POISON
            if b is POISON:
                return 0 if a == 0 else POISON
            return a * b % P
        if isinstance(e, cir.Scaled):
            v = ev(e.expr)
            if v is POISON:
                return 0 if e.scalar % P == 0 else POISON
            return v * e.scalar % P
        raise TypeError(f"cannot mock-evaluate {type(e)}")
    return ev(expr)


class MockProver:
    def __init__(self, cs, config, assembly, n):
        self.cs = cs
        self.config = config
        self.assembly = assembly
        self.n = n

    @classmethod
    def run(cls, k: int, circuit, instances, floor_planner=None) -> "MockProver":
        cs = ConstraintSystem()
        config = circuit.configure(cs)
        cs.chunk_lookups()
        cs.chunk_shuffles()
        n = 1 << k
        if n < cs.minimum_rows():
            raise NotEnoughRowsAvailable(k)
        usable = cs.usable_rows(n)
        inst_cols = [list(c) + [0] * (n - len(c)) for c in instances]
        if len(inst_cols) != cs.num_instance_columns:
            raise InvalidInstancesError()
        assembly = _MockAssembly(cs, n, usable, inst_cols)
        planner = floor_planner or SimpleFloorPlanner
        planner.synthesize(assembly, circuit, config, cs.constants)
        # capture each gate's queried (virtual) selectors and queried cells
        # BEFORE compression substitutes the selector expressions — the
        # CellNotAssigned check needs them (dev.rs:962-999 uses
        # gate.queried_selectors()/queried_cells())
        from halo2_tpu_torch.plonk import circuit as cir
        gate_selectors, gate_cells = [], []
        for gate in cs.gates:
            sels, qcells = set(), set()
            for poly in gate.polys:
                def walk(e):
                    if isinstance(e, cir.SelectorExpr):
                        sels.add(e.selector.index)
                    elif isinstance(e, cir.AdviceQuery):
                        qcells.add(("advice", e.column_index, e.rotation))
                    elif isinstance(e, cir.FixedQuery):
                        qcells.add(("fixed", e.column_index, e.rotation))
                    elif isinstance(e, (cir.Negated, cir.Scaled)):
                        walk(e.expr)
                    elif isinstance(e, (cir.Sum, cir.Product)):
                        walk(e.a)
                        walk(e.b)
                walk(poly)
            gate_selectors.append(sels)
            gate_cells.append(qcells)
        # pack selectors into combination fixed columns, exactly as keygen
        # does (dev.rs runs compress_selectors in MockProver::run too)
        if cs.num_selectors:
            combos = cs.compress_selectors(assembly.selectors)
            assembly.fixed.extend(combos)
        from halo2_tpu_torch.plonk.range_check import fill_and_sort
        for rel in cs.range_check:
            fill_and_sort(assembly.advice, rel, usable, -1)
        prover = cls(cs, config, assembly, n)
        prover._gate_selectors = gate_selectors
        prover._gate_cells = gate_cells
        return prover

    # -- located failures ----------------------------------------------------
    def _locate(self, row: int, columns=()) -> FailureLocation:
        """Find the enclosing region: covers the row and shares a column
        (metadata::FailureLocation::find_expressions)."""
        for r in self.assembly.regions:
            lo, hi = r.rows
            if lo is None or not (lo <= row <= hi):
                continue
            if not columns or any(c in r.columns for c in columns):
                return FailureLocation(row, r.index, r.name, row - lo)
        return FailureLocation(row)

    @staticmethod
    def _expr_columns(expr):
        from halo2_tpu_torch.plonk import circuit as cir
        cols = set()

        def walk(e):
            if isinstance(e, cir.FixedQuery):
                cols.add(("fixed", e.column_index))
            elif isinstance(e, cir.AdviceQuery):
                cols.add(("advice", e.column_index))
            elif isinstance(e, cir.InstanceQuery):
                cols.add(("instance", e.column_index))
            elif isinstance(e, (cir.Negated, cir.Scaled)):
                walk(e.expr)
            elif isinstance(e, (cir.Sum, cir.Product)):
                walk(e.a)
                walk(e.b)
        walk(expr)
        return cols

    def verify(self) -> list:
        return self.verify_at_rows(range(self.assembly.usable_rows),
                                   range(self.assembly.usable_rows))

    def _verify_cells_assigned(self) -> list:
        """CellNotAssigned (dev.rs:962-999): within each region, every cell
        queried by a gate whose selector is enabled in that region must have
        been assigned.  Instance cells are excluded — they are not assigned
        into regions."""
        failures = []
        n = self.n
        for r in self.assembly.regions:
            for sel_idx, at_rows in r.enabled_selectors.items():
                for gi, gate in enumerate(self.cs.gates):
                    if sel_idx not in self._gate_selectors[gi]:
                        continue
                    for sel_row in at_rows:
                        for ctype, col, rot in sorted(self._gate_cells[gi]):
                            cell_row = (sel_row + n + rot) % n
                            if r.is_assigned(ctype, col, cell_row):
                                continue
                            failures.append(VerifyFailure(
                                "cell_not_assigned",
                                f"{ctype} column {col} not assigned in "
                                f"region {r.index} ('{r.name}') for active "
                                f"gate '{gate.name}'",
                                gate=gate.name,
                                location=FailureLocation(
                                    cell_row, r.index, r.name,
                                    cell_row - r.rows[0]),
                                column=(ctype, col),
                                offset=cell_row - r.rows[0]))
        return failures

    def verify_at_rows(self, gate_row_ids, lookup_input_row_ids) -> list:
        """Row-subset verification (dev.rs:940-1030 verify_at_rows): gate
        constraints are checked only on `gate_row_ids` (plus the blinding
        rows, for poison detection), lookup inputs only on
        `lookup_input_row_ids`.  Both iterables must lie in the usable
        rows."""
        gate_row_ids = list(gate_row_ids)
        lookup_input_row_ids = list(lookup_input_row_ids)
        cs, asm = self.cs, self.assembly
        usable = asm.usable_rows
        for row in gate_row_ids + lookup_input_row_ids:
            if not (0 <= row < usable):
                raise ValueError(f"invalid row id {row}")
        failures = []
        n = self.n
        blinding_rows = range(n - (cs.blinding_factors() + 1), n)

        failures.extend(self._verify_cells_assigned())

        for gate in cs.gates:
            for pi, poly in enumerate(gate.polys):
                cols = self._expr_columns(poly)
                poisoned_reported = False
                for row in gate_row_ids + list(blinding_rows):
                    val = _eval_poison(
                        poly,
                        lambda q, r=row: asm.cell_value(
                            cs.fixed_queries[q.query_index][0], r + q.rotation),
                        lambda q, r=row: asm.cell_value(
                            cs.advice_queries[q.query_index][0], r + q.rotation),
                        lambda q, r=row: asm.cell_value(
                            cs.instance_queries[q.query_index][0], r + q.rotation))
                    name = gate.constraint_names[pi] or str(pi)
                    if val is POISON:
                        # dedup ConstraintPoisoned like dev.rs:1321-1333
                        if not poisoned_reported:
                            failures.append(VerifyFailure(
                                "gate_poisoned",
                                f"{gate.name}/{name} is active on an "
                                f"unusable row - missing selector?",
                                gate=gate.name, constraint=name))
                            poisoned_reported = True
                    elif val != 0:
                        failures.append(VerifyFailure(
                            "gate", f"{gate.name}/{name} not satisfied",
                            gate=gate.name, constraint=name,
                            location=self._locate(row, cols)))
                        break  # one failure per constraint is enough

        for left, right in asm.copies:
            lv = asm.cell_value(left.column, left.row)
            rv = asm.cell_value(right.column, right.row)
            if lv is POISON or rv is POISON or lv != rv:
                # report the mismatching VALUES — for instance columns this
                # is the "expected public input X, circuit produced Y"
                # debugging affordance (dev.rs permutation failure detail)
                def _fmt(v):
                    return "<poison>" if v is POISON else hex(v)
                failures.append(VerifyFailure(
                    "permutation",
                    f"copy {left.column}@{left.row} (= {_fmt(lv)}) != "
                    f"{right.column}@{right.row} (= {_fmt(rv)})",
                    location=self._locate(
                        left.row, {(left.column.ctype, left.column.index)})))

        failures.extend(self._verify_lookups(lookup_input_row_ids))
        failures.extend(self._verify_shuffles())
        return failures

    def _eval_at(self, expr, row):
        cs, asm = self.cs, self.assembly
        v = _eval_poison(
            expr,
            lambda q: asm.cell_value(cs.fixed_queries[q.query_index][0],
                                     row + q.rotation),
            lambda q: asm.cell_value(cs.advice_queries[q.query_index][0],
                                     row + q.rotation),
            lambda q: asm.cell_value(cs.instance_queries[q.query_index][0],
                                     row + q.rotation))
        return 0 if v is POISON else v

    def _verify_lookups(self, input_row_ids=None):
        out = []
        cs = self.cs
        usable = self.assembly.usable_rows
        if input_row_ids is None:
            input_row_ids = range(usable)

        for li, lookup in enumerate(cs.lookups):
            table = set()
            for row in range(usable):
                table.add(tuple(self._eval_at(t, row)
                                for t in lookup.table_expressions))
            for set_i, input_set in enumerate(lookup.input_expressions_sets):
                for inp_i, inputs in enumerate(input_set):
                    cols = set()
                    for e in inputs:
                        cols |= self._expr_columns(e)
                    for row in input_row_ids:
                        tup = tuple(self._eval_at(e, row) for e in inputs)
                        if tup not in table:
                            out.append(VerifyFailure(
                                "lookup",
                                f"lookup {li} (set {set_i}, input {inp_i}) "
                                f"not in table",
                                location=self._locate(row, cols)))
                            break
        return out

    def _verify_shuffles(self):
        out = []
        cs = self.cs
        usable = self.assembly.usable_rows

        for si, group in enumerate(cs.shuffles):
            for ui, unit in enumerate(group.units):
                left = sorted(tuple(self._eval_at(e, r)
                                    for e in unit.input_expressions)
                              for r in range(usable))
                right = sorted(tuple(self._eval_at(e, r)
                                     for e in unit.shuffle_expressions)
                               for r in range(usable))
                if left != right:
                    out.append(VerifyFailure(
                        "shuffle",
                        f"shuffle group {si} unit {ui} is not a permutation"))
        return out

    def assert_satisfied(self):
        failures = self.verify()
        if failures:
            raise AssertionError("MockProver failures:\n" +
                                 "\n".join(map(repr, failures)))
