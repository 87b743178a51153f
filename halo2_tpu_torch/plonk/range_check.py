"""Range check by sorted column.

Mirrors halo2_proofs/src/plonk/range_check.rs and the
`advice_column_range` API (plonk/circuit.rs:1771-1826): an origin advice
column is bound to a sort column by a shuffle; a 3-constraint gate pins
sort[0] = min, sort[last_active] = max, and successive differences in
{0..step}; the prover fills the origin column's tail with the full
[min..max] step sequence and produces the sort column by counting sort
(prover.rs:164-200, 1699-1779).
"""

from __future__ import annotations

from dataclasses import dataclass

from halo2_tpu_torch.plonk.error import NotEnoughRowsForRangeCheck


@dataclass
class RangeCheckRel:
    origin: object  # advice Column
    sort: object    # advice Column
    min: int
    max: int
    step: int

    def __post_init__(self):
        assert self.step != 0
        # the reference's bounds are u32 (range_check.rs:13-15) — negative
        # or >32-bit ranges are unrepresentable there, and signed values
        # would break the prover's uint64 column fast path here
        assert 0 <= self.min <= self.max <= 0xFFFFFFFF, \
            "range-check bounds must be u32 (range_check.rs:13-15)"

    def values(self):
        """The fill sequence: min, min+step, ..., max (clamped to max)."""
        cur = self.min
        while cur < self.max:
            yield cur
            cur = min(cur + self.step, self.max)
        yield self.max


def fill_and_sort(advice_cols, rel: RangeCheckRel, usable_rows: int,
                  max_assigned: int):
    """Apply the prover-side fill + counting sort to host column lists.

    advice_cols: list of per-column host int lists (mutated in place).
    max_assigned: highest user-assigned row of the origin column."""
    origin = advice_cols[rel.origin.index]
    sort_col = advice_cols[rel.sort.index]

    # fill [min..max] sequence descending from the last active row
    offset = usable_rows - 1
    for value in rel.values():
        origin[offset] = value
        offset -= 1
    if max_assigned > offset:
        raise NotEnoughRowsForRangeCheck("range-check fill overlaps assigned cells "
                         f"(assigned up to {max_assigned}, fill starts {offset + 1})")

    # counting sort of origin[0..usable) into sort[0..usable)
    span = rel.max - rel.min + 1
    counts = [0] * span
    for r in range(usable_rows):
        v = origin[r]
        if not (rel.min <= v <= rel.max):
            raise ValueError(
                f"range-check value {v} at row {r} outside [{rel.min}, {rel.max}]")
        counts[v - rel.min] += 1
    out = 0
    for i, cnt in enumerate(counts):
        val = rel.min + i
        for _ in range(cnt):
            sort_col[out] = val
            out += 1
    assert out == usable_rows
