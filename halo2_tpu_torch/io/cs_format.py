"""ConstraintSystem wire format — self-contained key files.

The reference serializes the full (post-compression) ConstraintSystem with
`write_cs`/`read_cs` (halo2_proofs/src/helpers.rs:406-587)
so CircuitData::read can rebuild keys WITHOUT re-running `configure()` —
keys must not silently break when circuit code is refactored.  This module
is this package's equivalent: a tagged little-endian binary format over
the Python ConstraintSystem (post selector compression), with the
reference's tagged Expression encoding (helpers.rs:589-743 analogue).

Layout (all ints little-endian u32 unless noted; field constants 32-byte
LE):
  magic "H2CS" | version u32
  num_fixed / num_advice / num_instance / num_selectors
  selector_map: count + fixed-column indices
  gates: count + per gate {name, constraint-count + per poly {name, expr}}
  advice/instance/fixed queries: count + (col_index, rot i32)
  permutation columns: count + (ctype u8, index)
  lookups: count + per argument {name, tables: exprs,
           sets: count + per set {count + per input {exprs}}}
  shuffles: group count + per group {unit count + per unit
           {name, inputs: exprs, shuffles: exprs}}
  range checks: count + (origin, sort, min i64, max i64, step i64)
  named advices: count + indices
  constants: count + fixed indices
  minimum_degree: i32 (-1 = None)
"""

from __future__ import annotations

import io
import struct

from halo2_tpu_torch.plonk import circuit as cir
from halo2_tpu_torch.plonk.logup import LogupArgument
from halo2_tpu_torch.plonk.range_check import RangeCheckRel
from halo2_tpu_torch.plonk.shuffle import ShuffleGroup, ShuffleUnit

_MAGIC = b"H2CS"
_VERSION = 1

_CTYPE_TAG = {"instance": 0, "advice": 1, "fixed": 2}
_TAG_CTYPE = {v: k for k, v in _CTYPE_TAG.items()}


def _w_u32(b, v):
    b.write(struct.pack("<I", v))


def _w_i32(b, v):
    b.write(struct.pack("<i", v))


def _w_i64(b, v):
    b.write(struct.pack("<q", v))


def _w_str(b, s: str):
    raw = s.encode()
    _w_u32(b, len(raw))
    b.write(raw)


def _w_field(b, v: int):
    b.write(int(v).to_bytes(32, "little"))


def _w_expr(b, e):
    """Tagged expression encoding (helpers.rs:589-743 analogue)."""
    if isinstance(e, cir.Constant):
        b.write(b"\x00")
        _w_field(b, e.value)
    elif isinstance(e, cir.FixedQuery):
        b.write(b"\x01")
        _w_u32(b, e.query_index)
        _w_u32(b, e.column_index)
        _w_i32(b, e.rotation)
    elif isinstance(e, cir.AdviceQuery):
        b.write(b"\x02")
        _w_u32(b, e.query_index)
        _w_u32(b, e.column_index)
        _w_i32(b, e.rotation)
    elif isinstance(e, cir.InstanceQuery):
        b.write(b"\x03")
        _w_u32(b, e.query_index)
        _w_u32(b, e.column_index)
        _w_i32(b, e.rotation)
    elif isinstance(e, cir.Negated):
        b.write(b"\x04")
        _w_expr(b, e.expr)
    elif isinstance(e, cir.Sum):
        b.write(b"\x05")
        _w_expr(b, e.a)
        _w_expr(b, e.b)
    elif isinstance(e, cir.Product):
        b.write(b"\x06")
        _w_expr(b, e.a)
        _w_expr(b, e.b)
    elif isinstance(e, cir.Scaled):
        b.write(b"\x07")
        _w_expr(b, e.expr)
        _w_field(b, e.scalar)
    else:
        raise TypeError(f"cannot serialize expression {type(e)} "
                        "(virtual selectors must be compressed first)")


def _w_exprs(b, exprs):
    _w_u32(b, len(exprs))
    for e in exprs:
        _w_expr(b, e)


def write_cs(cs) -> bytes:
    """Serialize a post-compression ConstraintSystem."""
    b = io.BytesIO()
    b.write(_MAGIC)
    _w_u32(b, _VERSION)
    _w_u32(b, cs.num_fixed_columns)
    _w_u32(b, cs.num_advice_columns)
    _w_u32(b, cs.num_instance_columns)
    _w_u32(b, cs.num_selectors)
    _w_u32(b, len(cs.selector_map))
    for col in cs.selector_map:
        _w_u32(b, col.index)
    _w_u32(b, len(cs.gates))
    for gate in cs.gates:
        _w_str(b, gate.name)
        _w_u32(b, len(gate.polys))
        for name, poly in zip(gate.constraint_names, gate.polys):
            _w_str(b, name)
            _w_expr(b, poly)
    for queries in (cs.advice_queries, cs.instance_queries, cs.fixed_queries):
        _w_u32(b, len(queries))
        for col, rot in queries:
            _w_u32(b, col.index)
            _w_i32(b, rot)
    _w_u32(b, len(cs.permutation.columns))
    for col in cs.permutation.columns:
        b.write(bytes([_CTYPE_TAG[col.ctype]]))
        _w_u32(b, col.index)
    _w_u32(b, len(cs.lookups))
    for lk in cs.lookups:
        _w_str(b, lk.name)
        _w_exprs(b, lk.table_expressions)
        _w_u32(b, len(lk.input_expressions_sets))
        for s in lk.input_expressions_sets:
            _w_u32(b, len(s))
            for inputs in s:
                _w_exprs(b, inputs)
    _w_u32(b, len(cs.shuffles))
    for group in cs.shuffles:
        _w_u32(b, len(group.units))
        for unit in group.units:
            _w_str(b, unit.name)
            _w_exprs(b, unit.input_expressions)
            _w_exprs(b, unit.shuffle_expressions)
    _w_u32(b, len(cs.range_check))
    for rel in cs.range_check:
        _w_u32(b, rel.origin.index)
        _w_u32(b, rel.sort.index)
        _w_i64(b, rel.min)
        _w_i64(b, rel.max)
        _w_i64(b, rel.step)
    _w_u32(b, len(cs.named_advices))
    for idx in cs.named_advices:
        _w_u32(b, idx)
    _w_u32(b, len(cs.constants))
    for col in cs.constants:
        _w_u32(b, col.index)
    _w_i32(b, -1 if cs.minimum_degree is None else cs.minimum_degree)
    return b.getvalue()


class _Reader:
    def __init__(self, data: bytes):
        self.b = io.BytesIO(data)

    def u32(self):
        return struct.unpack("<I", self.b.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.b.read(4))[0]

    def i64(self):
        return struct.unpack("<q", self.b.read(8))[0]

    def s(self):
        return self.b.read(self.u32()).decode()

    def field(self):
        return int.from_bytes(self.b.read(32), "little")

    def byte(self):
        return self.b.read(1)[0]

    def expr(self):
        tag = self.byte()
        if tag == 0:
            return cir.Constant(self.field())
        if tag in (1, 2, 3):
            q, c, r = self.u32(), self.u32(), self.i32()
            klass = {1: cir.FixedQuery, 2: cir.AdviceQuery,
                     3: cir.InstanceQuery}[tag]
            return klass(q, c, r)
        if tag == 4:
            return cir.Negated(self.expr())
        if tag == 5:
            return cir.Sum(self.expr(), self.expr())
        if tag == 6:
            return cir.Product(self.expr(), self.expr())
        if tag == 7:
            return cir.Scaled(self.expr(), self.field())
        raise ValueError(f"bad expression tag {tag}")

    def exprs(self):
        return [self.expr() for _ in range(self.u32())]


def read_cs(data: bytes):
    """Rebuild a ConstraintSystem from write_cs output — no configure()."""
    r = _Reader(data)
    if r.b.read(4) != _MAGIC:
        raise ValueError("not a halo2 CS blob (H2CS)")
    if r.u32() != _VERSION:
        raise ValueError("unsupported CS format version")
    cs = cir.ConstraintSystem()
    cs.num_fixed_columns = r.u32()
    cs.num_advice_columns = r.u32()
    cs.num_instance_columns = r.u32()
    cs.num_selectors = r.u32()
    cs._selectors_compressed = cs.num_selectors > 0
    cs.selector_map = [cir.Column(r.u32(), "fixed")
                       for _ in range(r.u32())]
    for _ in range(r.u32()):
        gname = r.s()
        polys, names = [], []
        for _ in range(r.u32()):
            names.append(r.s())
            polys.append(r.expr())
        cs.gates.append(cir.Gate(gname, polys, names))
    cs.advice_queries = [(cir.Column(r.u32(), "advice"), r.i32())
                         for _ in range(r.u32())]
    cs.instance_queries = [(cir.Column(r.u32(), "instance"), r.i32())
                           for _ in range(r.u32())]
    cs.fixed_queries = [(cir.Column(r.u32(), "fixed"), r.i32())
                        for _ in range(r.u32())]
    # num_advice_queries per column (blinding_factors needs it)
    cs.num_advice_queries = [0] * cs.num_advice_columns
    for col, _rot in cs.advice_queries:
        cs.num_advice_queries[col.index] += 1
    for _ in range(r.u32()):
        ctype = _TAG_CTYPE[r.byte()]
        cs.permutation.columns.append(cir.Column(r.u32(), ctype))
    for _ in range(r.u32()):
        name = r.s()
        tables = r.exprs()
        sets = []
        for _ in range(r.u32()):
            sets.append([r.exprs() for _ in range(r.u32())])
        cs.lookups.append(LogupArgument(name, tables, sets))
    for _ in range(r.u32()):
        units = []
        for _ in range(r.u32()):
            uname = r.s()
            units.append(ShuffleUnit(uname, r.exprs(), r.exprs()))
        cs.shuffles.append(ShuffleGroup(units))
    for _ in range(r.u32()):
        cs.range_check.append(RangeCheckRel(
            cir.Column(r.u32(), "advice"), cir.Column(r.u32(), "advice"),
            r.i64(), r.i64(), r.i64()))
    cs.named_advices = [r.u32() for _ in range(r.u32())]
    cs.constants = [cir.Column(r.u32(), "fixed") for _ in range(r.u32())]
    md = r.i32()
    cs.minimum_degree = None if md == -1 else md
    return cs
