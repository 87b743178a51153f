"""Circuit layout layer: regions, layouter, floor planners.

Python re-design of halo2_proofs/src/circuit.rs (548 LoC) and
circuit/floor_planner/: the `Layouter`/`Region` API that user circuits drive,
an `Assignment` backend protocol that keygen and the prover implement, and
two floor planners:

  * SimpleFloorPlanner — single-pass sequential region placement (the
    upstream `single_pass.rs` behavior): each region starts at the current
    per-column high-water mark across all columns.
  * FlatFloorPlanner  — the fork's parallel-witness planner
    (floor_planner/flat.rs:31-95): regions keep ABSOLUTE offsets with no
    relocation, enabling parallel synthesis of independent regions.

Values are canonical Python ints mod Fr.p (or callables returning one).
"""

from __future__ import annotations

from dataclasses import dataclass

from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.plonk.circuit import Column, Selector
from halo2_tpu_torch.plonk.error import NotEnoughColumnsForConstants

P = FR_MODULUS


@dataclass(frozen=True)
class Cell:
    column: Column
    row: int


@dataclass
class AssignedCell:
    cell: Cell
    value: int | None

    def value_or(self, default: int) -> int:
        return self.value if self.value is not None else default


def _resolve(value):
    v = value() if callable(value) else value
    if v is None:
        return None
    if isinstance(v, int):
        return v % P
    return v       # Assigned (deferred division) passes through unresolved


class Assignment:
    """Backend protocol (plonk/circuit.rs:299-403)."""

    def enter_region(self, name):  # noqa: D401
        pass

    def exit_region(self):
        pass

    def enable_selector(self, selector: Selector, row: int):
        raise NotImplementedError

    def assign_advice(self, column: Column, row: int, value):
        raise NotImplementedError

    def assign_fixed(self, column: Column, row: int, value):
        raise NotImplementedError

    def copy(self, left: Cell, right: Cell):
        raise NotImplementedError

    def query_instance(self, column: Column, row: int):
        raise NotImplementedError

    def fill_from_row(self, column: Column, from_row: int, value):
        pass

    def assign_advice_bulk(self, column: Column, from_row: int, values):
        """Vectorized advice assignment (default: per-cell loop)."""
        for i, v in enumerate(values):
            self.assign_advice(column, from_row + i, v)

    def is_in_prove_mode(self) -> bool:
        return False


class Chip:
    """Base class for chips — reusable circuit components that own a config
    produced by their `configure` classmethod and drive a Layouter in their
    instruction methods (circuit.rs:25-70).  Purely organizational: gadgets
    compose chips, chips compose regions."""

    def __init__(self, config):
        self.config = config

    @classmethod
    def configure(cls, meta, *args, **kwargs):
        raise NotImplementedError


class Region:
    """A region view handed to user assignment closures."""

    def __init__(self, layouter: "_RegionLayouter"):
        self._l = layouter

    def assign_advice(self, annotation, column: Column, offset: int, value) -> AssignedCell:
        return self._l.assign_advice(column, offset, _resolve(value))

    def assign_advice_from_constant(self, annotation, column: Column, offset: int,
                                    constant: int) -> AssignedCell:
        cell = self._l.assign_advice(column, offset, constant % P)
        self._l.constrain_constant(cell.cell, constant % P)
        return cell

    def assign_advice_from_instance(self, annotation, instance: Column, row: int,
                                    advice: Column, offset: int) -> AssignedCell:
        value = self._l.backend.query_instance(instance, row)
        cell = self._l.assign_advice(advice, offset, value)
        self._l.backend.copy(Cell(instance, row), cell.cell)
        return cell

    def assign_fixed(self, annotation, column: Column, offset: int, value) -> AssignedCell:
        return self._l.assign_fixed(column, offset, _resolve(value))

    def assign_advice_bulk(self, annotation, column: Column, offset: int,
                           values) -> None:
        """Assign a contiguous run of advice values in one call — the
        fast path for row-filling circuits (the fork's parallel witness
        synthesis analogue)."""
        row0 = self._l._abs(offset + len(values) - 1) - (len(values) - 1)
        self._l.backend.assign_advice_bulk(column, row0, values)
        self._l.layouter.mark(column, row0 + len(values) - 1)

    def enable_selector(self, annotation, selector: Selector, offset: int):
        self._l.enable_selector(selector, offset)

    def constrain_equal(self, left: Cell, right: Cell):
        self._l.backend.copy(left, right)

    def constrain_constant(self, cell: Cell, constant: int):
        self._l.constrain_constant(cell, constant % P)


class _RegionLayouter:
    def __init__(self, layouter: "SingleChipLayouter", start: int):
        self.layouter = layouter
        self.backend = layouter.backend
        self.start = start
        self.rows_used = 0
        self.table_track = None  # {column: (first_value, rows_used)}

    def _abs(self, offset: int) -> int:
        self.rows_used = max(self.rows_used, offset + 1)
        return self.start + offset

    def assign_advice(self, column, offset, value) -> AssignedCell:
        row = self._abs(offset)
        self.backend.assign_advice(column, row, value)
        self.layouter.mark(column, row)
        return AssignedCell(Cell(column, row), value)

    def assign_fixed(self, column, offset, value) -> AssignedCell:
        row = self._abs(offset)
        self.backend.assign_fixed(column, row, value)
        self.layouter.mark(column, row)
        if self.table_track is not None:
            first, rows = self.table_track.get(column, (value, 0))
            self.table_track[column] = (first, max(rows, offset + 1))
        return AssignedCell(Cell(column, row), value)

    def enable_selector(self, selector, offset):
        row = self._abs(offset)
        self.backend.enable_selector(selector, row)
        # virtual selectors have no column yet (compression happens in
        # keygen); track placement under the selector itself, mirroring the
        # reference's RegionColumn::Selector
        self.layouter.mark(selector, row)

    def constrain_constant(self, cell, constant):
        self.layouter.constrain_constant(cell, constant)


class SingleChipLayouter:
    """Sequential region placement over one 'chip' (single_pass semantics)."""

    def __init__(self, backend: Assignment, constants: list[Column], flat: bool = False):
        self.backend = backend
        self.constants = constants
        self.flat = flat
        self.columns_high_water: dict[Column, int] = {}
        self._constants_used = 0
        self._pending_constants: list[tuple[Cell, int]] = []

    # region placement ----------------------------------------------------
    def _next_start(self) -> int:
        if self.flat:
            return 0
        return max(self.columns_high_water.values(), default=0)

    def mark(self, column: Column, row: int):
        cur = self.columns_high_water.get(column, 0)
        if row + 1 > cur:
            self.columns_high_water[column] = row + 1

    def assign_region(self, name, fn):
        start = self._next_start()
        rl = _RegionLayouter(self, start)
        self.backend.enter_region(name)
        result = fn(Region(rl))
        self.backend.exit_region()
        return result

    def assign_regions(self, name, fns, workers=None):
        """Assign a batch of independent regions, in forked workers when
        the backend supports it (flat planner, more than one closure,
        prove mode and a shared-memory witness backend: the rayon fan-out
        of prover.rs:1525-1781 / flat.rs:286-336; plonk/parallel_synthesis
        .py).  The closures must write disjoint cells, not use
        constrain_constant and hold no tensor.  Keygen, MockProver, the
        other planners, `workers=1` and a backend with a degraded advice
        column run them in turn, so circuits written against this API run
        everywhere.  Returns the closures' results in order (from workers:
        results that do not pickle come back as None)."""
        can_parallel = (
            self.flat and len(fns) > 1
            and (workers is None or workers > 1)
            and self.backend.is_in_prove_mode()
            and getattr(self.backend, "supports_parallel_regions",
                        lambda: False)())
        if can_parallel:
            from halo2_tpu_torch.plonk.parallel_synthesis import \
                run_parallel_regions
            return run_parallel_regions(self, fns, workers)
        return [self.assign_region(f"{name}#{i}", fn)
                for i, fn in enumerate(fns)]

    def assign_table(self, name, fn):
        """Table region: after assignment, each touched fixed column is
        filled to the end of the usable area with its FIRST assigned value
        (the DefaultTableValue logic of floor_planner/single_pass.rs:29-150,
        so lookups against default rows remain closed)."""
        start = self._next_start()
        rl = _RegionLayouter(self, start)
        rl.table_track = {}
        self.backend.enter_region(name)
        result = fn(Region(rl))
        self.backend.exit_region()
        for col, (first_val, rows) in rl.table_track.items():
            self.backend.fill_from_row(col, start + rows, first_val)
        return result

    def constrain_instance(self, cell: Cell, instance: Column, row: int):
        self.backend.copy(cell, Cell(instance, row))

    def constrain_constant(self, cell: Cell, constant: int):
        if not self.constants:
            raise NotEnoughColumnsForConstants()
        col = self.constants[0]
        row = self._constants_used
        self._constants_used += 1
        self.backend.assign_fixed(col, row, constant)
        self.mark(col, row)
        self.backend.copy(Cell(col, row), cell)

    def namespace(self, name):
        return self

    def get_root(self):
        return self


class SimpleFloorPlanner:
    """Single-pass sequential planner."""

    @staticmethod
    def synthesize(backend: Assignment, circuit, config, constants):
        layouter = SingleChipLayouter(backend, constants, flat=False)
        circuit.synthesize(config, layouter)


class FlatFloorPlanner:
    """Absolute-offset planner (fork's flat.rs): regions at offset 0, no
    relocation — circuits place their own absolute rows."""

    @staticmethod
    def synthesize(backend: Assignment, circuit, config, constants):
        layouter = SingleChipLayouter(backend, constants, flat=True)
        circuit.synthesize(config, layouter)


# ---------------------------------------------------------------------------
# V1 floor planner — upstream two-pass slot-in planner
# (reference: circuit/floor_planner/v1.rs (605 LoC) + v1/strategy.rs (265)).
#
# Pass 1 measures every region's shape (columns touched x row count) on the
# witness-free circuit; the strategy packs regions "biggest advice area
# first" into the earliest rows where ALL the region's columns have a free
# interval (first-fit with slack, strategy.rs:106-161); constants are then
# placed into the leftover holes of the constants columns
# (v1.rs:98-147).  Pass 2 replays synthesis with the planned region starts.
# ---------------------------------------------------------------------------

class _RegionShape:
    __slots__ = ("index", "columns", "row_count")

    def __init__(self, index: int):
        self.index = index
        self.columns: set[Column] = set()
        self.row_count = 0


class _NullBackend(Assignment):
    """Measurement-pass backend: records nothing, satisfies every call."""

    def __init__(self, shape: _RegionShape):
        self._shape = shape

    def enable_selector(self, selector, row):
        pass

    def assign_advice(self, column, row, value):
        pass

    def assign_fixed(self, column, row, value):
        pass

    def assign_advice_bulk(self, column, from_row, values):
        self._shape.columns.add(column)

    def copy(self, left, right):
        pass

    def query_instance(self, column, row):
        return None


class _ShapeRegionLayouter:
    """Implements the _RegionLayouter interface, recording the region shape
    instead of assigning (the MeasurementPass of v1.rs:248-320)."""

    def __init__(self, shape: _RegionShape, layouter):
        self.shape = shape
        self.layouter = layouter
        self.backend = _NullBackend(shape)

    def _abs(self, offset: int) -> int:
        self.shape.row_count = max(self.shape.row_count, offset + 1)
        return offset

    def assign_advice(self, column, offset, value) -> AssignedCell:
        self.shape.columns.add(column)
        return AssignedCell(Cell(column, self._abs(offset)), value)

    def assign_fixed(self, column, offset, value) -> AssignedCell:
        self.shape.columns.add(column)
        return AssignedCell(Cell(column, self._abs(offset)), value)

    def enable_selector(self, selector, offset):
        self.shape.columns.add(selector)   # RegionColumn::Selector
        self._abs(offset)

    def constrain_constant(self, cell, constant):
        pass


class _V1MeasureLayouter:
    """Layouter for the measurement pass: collects region shapes, skips
    tables/instance/namespace work (v1.rs:188-245 Measurement arms)."""

    def __init__(self):
        self.shapes: list[_RegionShape] = []

    def mark(self, column, row):
        pass

    def assign_region(self, name, fn):
        shape = _RegionShape(len(self.shapes))
        self.shapes.append(shape)
        return fn(Region(_ShapeRegionLayouter(shape, self)))

    def assign_regions(self, name, fns, workers=None):
        return [self.assign_region(f"{name}#{i}", fn)
                for i, fn in enumerate(fns)]

    def assign_table(self, name, fn):
        return None

    def constrain_instance(self, cell, instance, row):
        pass

    def constrain_constant(self, cell, constant):
        pass

    def namespace(self, name):
        return self

    def get_root(self):
        return self


def _free_intervals(alloc: list[tuple[int, int]], start: int, end):
    """Unallocated nonempty intervals of a column intersecting [start, end).

    alloc: sorted disjoint (start, length) pairs; end=None is unbounded.
    Mirrors Allocations::free_intervals (strategy.rs:60-98).  Yields
    (space_start, space_end_or_None)."""
    row = start
    for a_start, a_len in alloc:
        if end is not None and a_start >= end:
            return
        if row < a_start:
            yield (row, a_start)
        row = max(row, a_start + a_len)
    if end is None or row < end:
        yield (row, end)


def _first_fit_region(column_allocations, region_columns, region_length,
                      start, slack):
    """First-fit with slack across the region's columns
    (strategy.rs:106-161).  Returns the start row, or None."""
    if not region_columns:
        return start
    c, rest = region_columns[0], region_columns[1:]
    end = None if slack is None else start + region_length + slack
    alloc = column_allocations.setdefault(c, [])
    for space_start, space_end in list(_free_intervals(alloc, start, end)):
        s_slack = None if space_end is None else \
            space_end - space_start - region_length
        if s_slack is None or s_slack >= 0:
            row = _first_fit_region(column_allocations, rest, region_length,
                                    space_start, s_slack)
            if row is not None:
                alloc.append((row, region_length))
                alloc.sort()
                return row
    return None


def _slot_in_biggest_advice_first(shapes: list[_RegionShape]):
    """Sort regions by advice area desc, first-fit each (strategy.rs:196-225).
    Returns (starts_by_region_index, column_allocations)."""
    order = sorted(
        shapes,
        key=lambda s: sum(
            1 for c in s.columns if getattr(c, "ctype", None) == "advice")
        * s.row_count,
        reverse=True)
    column_allocations: dict[Column, list[tuple[int, int]]] = {}
    starts = [0] * len(shapes)
    def _col_key(c):
        # RegionColumn ordering: Column(..) < Selector(..) (v1 strategy)
        if isinstance(c, Selector):
            return (1, c.index, 0)
        from halo2_tpu_torch.plonk.circuit import _CTYPE_ORDER
        return (0, _CTYPE_ORDER[c.ctype], c.index)

    for shape in order:
        cols = sorted(shape.columns, key=_col_key)
        row = _first_fit_region(column_allocations, cols, shape.row_count,
                                0, None)
        starts[shape.index] = row
    return starts, column_allocations


class _V1AssignLayouter(SingleChipLayouter):
    """Assignment pass: regions at planned starts; constants deferred to the
    end-of-synthesis hole-filling placement (v1.rs:127-160)."""

    def __init__(self, backend, constants, starts):
        super().__init__(backend, constants, flat=False)
        self._starts = starts
        self._region_idx = 0
        self.deferred_constants: list[tuple[int, Cell]] = []

    def assign_region(self, name, fn):
        start = self._starts[self._region_idx]
        self._region_idx += 1
        rl = _RegionLayouter(self, start)
        self.backend.enter_region(name)
        result = fn(Region(rl))
        self.backend.exit_region()
        return result

    def constrain_constant(self, cell: Cell, constant: int):
        if not self.constants:
            raise NotEnoughColumnsForConstants()
        self.deferred_constants.append((constant, cell))


class V1FloorPlanner:
    """Upstream two-pass planner: measure → slot-in pack → assign."""

    @staticmethod
    def synthesize(backend: Assignment, circuit, config, constants):
        # Pass 1: measure the witness-free circuit.
        measure = _V1MeasureLayouter()
        circuit.without_witnesses().synthesize(config, measure)
        starts, column_allocations = _slot_in_biggest_advice_first(
            measure.shapes)

        first_unassigned_row = max(
            (a[-1][0] + a[-1][1] for a in column_allocations.values() if a),
            default=0)

        # Pass 2: assign regions at their planned starts.
        layouter = _V1AssignLayouter(backend, constants, starts)
        circuit.synthesize(config, layouter)

        # Place constants into the holes of the constants columns below the
        # first unassigned row (v1.rs:98-147).
        consts = layouter.deferred_constants
        if consts:
            positions = []
            for col in constants:
                alloc = column_allocations.get(col, [])
                for s, e in _free_intervals(alloc, 0, first_unassigned_row):
                    positions.extend((col, r) for r in range(s, e))
            if len(positions) < len(consts):
                raise NotEnoughColumnsForConstants(
                    f"{len(consts)} constants, {len(positions)} free rows")
            consts.sort(key=lambda pc: (pc[1].column, pc[1].row))
            for (col, row), (value, cell) in zip(positions, consts):
                backend.assign_fixed(col, row, value)
                layouter.mark(col, row)
                backend.copy(Cell(col, row), cell)
