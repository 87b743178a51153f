"""The `standard_plonk` configuration on the port's circuit API: the halo2
criterion bench's StandardPlonk `MyCircuit` (benches/plonk.rs), its rows
assigned in one region instead of one region per row.

Advice a, b, c and fixed sm, sa, sb, sc; the gate
a*sa + b*sb + a*b*sm - c*sc; a, b, c in the permutation.  Row pairs
(raw_multiply, raw_add) fill the usable rows, each with the bench's two
copies (benchmark/reference/standard_plonk.py has the table of values)."""

from __future__ import annotations

from halo2_tpu_torch.circuit import Cell
from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.plonk import Circuit

P = FR_MODULUS


class StandardPlonk(Circuit):
    def __init__(self, k: int, witness: int | None = None):
        self.k = k
        self.witness = witness

    def without_witnesses(self):
        return StandardPlonk(self.k)

    def configure(self, meta):
        a = meta.advice_column()
        b = meta.advice_column()
        c = meta.advice_column()
        for col in (a, b, c):
            meta.enable_equality(col)
        sm = meta.fixed_column()
        sa = meta.fixed_column()
        sb = meta.fixed_column()
        sc = meta.fixed_column()

        def gate(m):
            qa = m.query_advice(a, 0)
            qb = m.query_advice(b, 0)
            qc = m.query_advice(c, 0)
            fa = m.query_fixed(sa, 0)
            fb = m.query_fixed(sb, 0)
            fc = m.query_fixed(sc, 0)
            fm = m.query_fixed(sm, 0)
            return [("", qa * fa + qb * fb + qa * qb * fm - qc * fc)]

        meta.create_gate("Combined add-mult", gate)
        return a, b, c, sm, sa, sb, sc

    def synthesize(self, config, layouter):
        a, b, c, sm, sa, sb, sc = config
        rows = (1 << self.k) - 6
        # the witness backend keeps no fixed cells and no copies (keygen's
        # does), so proving skips the per-cell calls for them
        keyed = not layouter.backend.is_in_prove_mode()

        def region(r):
            if self.witness is not None:
                w = self.witness % P
                sq = w * w % P
                r.assign_advice_bulk("lhs", a, 0, [w] * rows)
                r.assign_advice_bulk("rhs", b, 0, [w, sq] * (rows // 2))
                r.assign_advice_bulk("out", c, 0,
                                     [sq, (sq + w) % P] * (rows // 2))
            if not keyed:
                return
            for j in range(0, rows, 2):
                # raw_multiply: sa = sb = 0, sc = sm = 1
                r.assign_fixed("c", sc, j, 1)
                r.assign_fixed("a * b", sm, j, 1)
                # raw_add: sa = sb = sc = 1, sm = 0
                r.assign_fixed("a", sa, j + 1, 1)
                r.assign_fixed("b", sb, j + 1, 1)
                r.assign_fixed("c", sc, j + 1, 1)
                r.constrain_equal(Cell(a, j), Cell(a, j + 1))
                r.constrain_equal(Cell(b, j + 1), Cell(c, j))

        layouter.assign_region("standard plonk rows", region)


FLOOR_PLANNER = None


def circuit(k: int, witness: int | None = None) -> StandardPlonk:
    return StandardPlonk(k, witness)


def instances(k: int, witness) -> list:
    return []
