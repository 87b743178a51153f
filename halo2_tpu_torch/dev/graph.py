"""Circuit layout rendering — the `dev-graph` feature analogue.

The reference renders circuit layouts with the `plotters` crate behind the
`dev-graph` cargo feature (halo2_proofs/src/dev/graph/
layout.rs: `CircuitLayout::render` draws columns as vertical lanes, regions
as labelled boxes, assigned cells as marks).  This is a dependency-free
re-design: a layout-tracking `Assignment` backend collects the geometry
during a witness-free synthesis pass, and `CircuitLayout.render_svg`
emits a standalone SVG.

Usage:
    from halo2_tpu_torch.dev.graph import CircuitLayout
    CircuitLayout().render(circuit, k, path="layout.svg")
"""

from __future__ import annotations

import html
from dataclasses import dataclass, field

from halo2_tpu_torch.circuit import Assignment, Cell, SimpleFloorPlanner


@dataclass
class _RegionInfo:
    name: str
    columns: set = field(default_factory=set)   # (ctype, index)
    rows: list = field(default_factory=lambda: [None, None])  # [min, max]
    cells: int = 0

    def note(self, ctype, index, row):
        self.columns.add((ctype, index))
        self.note_rows(row)
        self.cells += 1

    def note_rows(self, row):
        lo, hi = self.rows
        self.rows = [row if lo is None else min(lo, row),
                     row if hi is None else max(hi, row)]


class LayoutTracker(Assignment):
    """Records region geometry + per-cell marks during synthesis (no
    witness values required — mirrors MockProver's shape collection)."""

    def __init__(self, cs, n):
        self.cs = cs
        self.n = n
        self.regions: list[_RegionInfo] = []
        self._current: _RegionInfo | None = None
        self.loose_cells = []       # assignments outside any region
        self.selectors = []         # (selector_index, row)
        self.equality = []          # (Cell, Cell)
        self.advice_marks = set()   # (index, row)
        self.fixed_marks = set()
        self.instance_marks = set()

    # -- region protocol ---------------------------------------------------
    def enter_region(self, name):
        self._current = _RegionInfo(str(name))

    def exit_region(self):
        if self._current is not None:
            self.regions.append(self._current)
        self._current = None

    def _note(self, ctype, index, row):
        mark = {"advice": self.advice_marks, "fixed": self.fixed_marks,
                "instance": self.instance_marks}[ctype]
        mark.add((index, row))
        if self._current is not None:
            self._current.note(ctype, index, row)
        else:
            self.loose_cells.append((ctype, index, row))

    # -- Assignment protocol -------------------------------------------------
    def enable_selector(self, selector, row):
        self.selectors.append((selector.index, row))
        if self._current is not None:
            self._current.note_rows(row)

    def assign_advice(self, column, row, value):
        self._note("advice", column.index, row)

    def assign_fixed(self, column, row, value):
        self._note("fixed", column.index, row)

    def copy(self, left: Cell, right: Cell):
        self.equality.append((left, right))

    def query_instance(self, column, row):
        self._note("instance", column.index, row)
        return 0

    def fill_from_row(self, column, from_row, value):
        self._note("fixed", column.index, from_row)

    def assign_advice_bulk(self, column, from_row, values):
        for i in range(len(values)):
            self._note("advice", column.index, from_row + i)

    def is_in_prove_mode(self):
        return False


_PALETTE = {
    "advice": "#e8f1fb",
    "fixed": "#fdeee0",
    "instance": "#eafaea",
}
_MARK = {
    "advice": "#4a90d9",
    "fixed": "#e67e22",
    "instance": "#27ae60",
}
_REGION_FILLS = ["#c7d9f2", "#f2d4c7", "#d9f2c7", "#e8c7f2", "#f2eec7"]


class CircuitLayout:
    """Render a circuit's layout to SVG (dev/graph/layout.rs analogue)."""

    def __init__(self, cell_w: int = 14, cell_h: int = 14,
                 max_rows: int | None = None):
        self.cell_w = cell_w
        self.cell_h = cell_h
        self.max_rows = max_rows

    def render(self, circuit, k: int, path: str | None = None) -> str:
        """Synthesize (witness-free) and return the SVG text; if `path` is
        given, also write it there."""
        from halo2_tpu_torch.plonk.circuit import ConstraintSystem

        cs = ConstraintSystem()
        config = circuit.configure(cs)
        cs.chunk_lookups()
        cs.chunk_shuffles()
        n = 1 << k
        tracker = LayoutTracker(cs, n)
        SimpleFloorPlanner.synthesize(tracker, circuit.without_witnesses(),
                                      config, cs.constants)
        svg = self._emit(cs, tracker, n)
        if path:
            with open(path, "w") as fh:
                fh.write(svg)
        return svg

    # ------------------------------------------------------------------
    def _emit(self, cs, tr: LayoutTracker, n: int) -> str:
        # column order: advice | fixed | instance (lanes left to right)
        lanes = []   # (ctype, index)
        for i in range(cs.num_advice_columns):
            lanes.append(("advice", i))
        for i in range(cs.num_fixed_columns):
            lanes.append(("fixed", i))
        for i in range(cs.num_instance_columns):
            lanes.append(("instance", i))
        lane_of = {ci: x for x, ci in enumerate(lanes)}

        used_rows = [r for info in tr.regions for r in info.rows
                     if r is not None]
        used_rows += [r for (_, _, r) in tr.loose_cells]
        used_rows += [r for (_, r) in tr.selectors]
        max_row = max(used_rows, default=0) + 2
        rows = min(self.max_rows or max_row, max_row, n)

        W, H = self.cell_w, self.cell_h
        top, left = 30, 46
        width = left + len(lanes) * W + 10
        height = top + rows * H + 10
        out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
               f'height="{height}" font-family="monospace" font-size="9">']
        out.append(f'<rect width="{width}" height="{height}" fill="white"/>')

        # lanes
        for x, (ctype, idx) in enumerate(lanes):
            px = left + x * W
            out.append(f'<rect x="{px}" y="{top}" width="{W}" '
                       f'height="{rows * H}" fill="{_PALETTE[ctype]}" '
                       f'stroke="#ccc" stroke-width="0.5"/>')
            out.append(f'<text x="{px + 2}" y="{top - 14}" '
                       f'transform="rotate(-35 {px + 2} {top - 14})">'
                       f'{ctype[0]}{idx}</text>')
        # row labels
        for r in range(0, rows, max(rows // 16, 1)):
            out.append(f'<text x="2" y="{top + r * H + H - 3}">{r}</text>')

        # regions (boxes spanning their column range and row range)
        for ri, info in enumerate(tr.regions):
            if info.rows[0] is None or not info.columns:
                continue
            xs = [lane_of[c] for c in info.columns if c in lane_of]
            if not xs:
                continue
            x0, x1 = min(xs), max(xs)
            r0, r1 = info.rows
            if r0 >= rows:
                continue
            r1 = min(r1, rows - 1)
            fill = _REGION_FILLS[ri % len(_REGION_FILLS)]
            out.append(
                f'<rect x="{left + x0 * W}" y="{top + r0 * H}" '
                f'width="{(x1 - x0 + 1) * W}" height="{(r1 - r0 + 1) * H}" '
                f'fill="{fill}" fill-opacity="0.6" stroke="#555" '
                f'stroke-width="0.8"/>')
            out.append(f'<title>{html.escape(info.name)}</title>')
            out.append(
                f'<text x="{left + x0 * W + 1}" y="{top + r0 * H - 1}" '
                f'fill="#333">{html.escape(info.name[:14])}</text>')

        # cell marks
        for ctype, marks in (("advice", tr.advice_marks),
                             ("fixed", tr.fixed_marks),
                             ("instance", tr.instance_marks)):
            color = _MARK[ctype]
            for idx, row in sorted(marks):
                if row >= rows or (ctype, idx) not in lane_of:
                    continue
                px = left + lane_of[(ctype, idx)] * W
                py = top + row * H
                out.append(f'<rect x="{px + 2}" y="{py + 2}" '
                           f'width="{W - 4}" height="{H - 4}" '
                           f'fill="{color}"/>')

        # equality constraints as connecting lines
        for a, b in tr.equality:
            ka = (a.column.ctype, a.column.index)
            kb = (b.column.ctype, b.column.index)
            if ka not in lane_of or kb not in lane_of:
                continue
            if a.row >= rows or b.row >= rows:
                continue
            x1 = left + lane_of[ka] * W + W // 2
            y1 = top + a.row * H + H // 2
            x2 = left + lane_of[kb] * W + W // 2
            y2 = top + b.row * H + H // 2
            out.append(f'<line x1="{x1}" y1="{y1}" x2="{x2}" y2="{y2}" '
                       f'stroke="#c0392b" stroke-width="0.8" '
                       f'stroke-dasharray="2,2"/>')

        out.append("</svg>")
        return "\n".join(out)
