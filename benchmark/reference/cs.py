"""A circuit's constraint system, read from its pinned text: the string that
halo2 hashes into every transcript as part of the verifying key
(`PinnedConstraintSystem{...}`, the reference fork's plonk/circuit.rs
`to_string`).  The text names every gate polynomial, every query, the
permutation's columns, the logup arguments (input sets and table) and the
shuffles, so the verifier below needs nothing else of the circuit.

Expressions become tuples: ("const", v), ("fixed" | "advice" | "instance",
query index), ("neg", e), ("sum", a, b), ("prod", a, b), ("scaled", e, v).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from benchmark.reference.bn254 import R

_COLUMN = re.compile(r"Column \{ index: (\d+), column_type: (\w+) \}")
_QUERY = re.compile(r"\(Column \{ index: (\d+), column_type: (\w+) \}, "
                    r"Rotation\((-?\d+)\)\)")


@dataclass
class ConstraintSystem:
    text: str
    num_fixed: int
    num_advice: int
    num_instance: int
    gates: list
    advice_queries: list      # [(column index, rotation)]
    instance_queries: list
    fixed_queries: list
    permutation: list         # [(kind, column index)], kind lower case
    lookups: list = field(default_factory=list)   # [(sets, table exprs)]
    shuffles: list = field(default_factory=list)  # [[(inputs, shuffles)]]

    def blinding_factors(self) -> int:
        """max(3, most queries of one advice column) + 2 (the reference's
        blinding_factors: one for the multiopen, one against off-by-one)."""
        per_column = {}
        for col, _ in self.advice_queries:
            per_column[col] = per_column.get(col, 0) + 1
        return max(3, max(per_column.values(), default=1)) + 2

    def query_index(self, kind: str, column: int, rotation: int = 0) -> int:
        queries = {"advice": self.advice_queries, "fixed": self.fixed_queries,
                   "instance": self.instance_queries}[kind]
        return queries.index((column, rotation))


class _Parser:
    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def eat(self, lit: str):
        if not self.s.startswith(lit, self.i):
            raise ValueError(f"expected {lit!r} at {self.s[self.i:self.i + 40]!r}")
        self.i += len(lit)

    def peek(self, lit: str) -> bool:
        return self.s.startswith(lit, self.i)

    def number(self) -> int:
        m = re.compile(r"0x[0-9a-f]+|-?\d+").match(self.s, self.i)
        if not m:
            raise ValueError(f"expected a number at {self.s[self.i:self.i + 40]!r}")
        self.i = m.end()
        return int(m.group(0), 0)

    def expr(self):
        for kind, name in (("fixed", "Fixed"), ("advice", "Advice"),
                           ("instance", "Instance")):
            if self.peek(name + " {"):
                self.eat(name + " { query_index: ")
                q = self.number()
                self.eat(", column_index: ")
                self.number()
                self.eat(", rotation: Rotation(")
                self.number()
                self.eat(") }")
                return (kind, q)
        if self.peek("Constant("):
            self.eat("Constant(")
            v = self.number()
            self.eat(")")
            return ("const", v % R)
        if self.peek("Negated("):
            self.eat("Negated(")
            e = self.expr()
            self.eat(")")
            return ("neg", e)
        for kind, name in (("sum", "Sum("), ("prod", "Product(")):
            if self.peek(name):
                self.eat(name)
                a = self.expr()
                self.eat(", ")
                b = self.expr()
                self.eat(")")
                return (kind, a, b)
        if self.peek("Scaled("):
            self.eat("Scaled(")
            e = self.expr()
            self.eat(", ")
            v = self.number()
            self.eat(")")
            return ("scaled", e, v % R)
        raise ValueError(f"unknown expression at {self.s[self.i:self.i + 40]!r}")

    def expr_list(self, sep: str = ", ") -> list:
        """`[e, e, ...]`"""
        self.eat("[")
        out = []
        while not self.peek("]"):
            if out:
                self.eat(sep)
            out.append(self.expr())
        self.eat("]")
        return out


def _section(text: str, key: str, next_key: str | None) -> str:
    start = text.index("," + key + ":") + len(key) + 2
    end = text.index("," + next_key + ":", start) if next_key else len(text)
    return text[start:end]


def parse(text: str) -> ConstraintSystem:
    text = text.strip()
    head = re.match(r"PinnedConstraintSystem\{num_fixed_columns:(\d+),"
                    r"num_advice_columns:(\d+),num_instance_columns:(\d+),",
                    text)
    if not head:
        raise ValueError("not a pinned constraint system")
    keys = ["gates", "advice_queries", "instance_queries", "fixed_queries",
            "permutation", "lookups", "shuffles", "constants"]
    sec = {k: _section(text, k, nxt) for k, nxt in zip(keys, keys[1:] + [None])}

    p = _Parser(sec["gates"])
    p.eat("[")
    gates = []
    while not p.peek("]"):
        gates.append(p.expr())
        p.eat(",")

    def queries(body, kind):
        return [(int(c), int(r)) for c, t, r in _QUERY.findall(body)
                if t.lower() == kind]

    lookups = []
    p = _Parser(sec["lookups"])
    p.eat("[")
    while not p.peek("]"):
        p.eat("(lookup")
        p.number()
        p.eat(",[")
        sets = []
        while not p.peek("]"):
            if sets:
                p.eat(", ")
            p.eat("InputExpressionSet([")
            inputs = []
            while not p.peek("]"):
                if inputs:
                    p.eat(", ")
                inputs.append(p.expr_list())
            p.eat("])")
            sets.append(inputs)
        p.eat("],")
        table = p.expr_list()
        p.eat("),")
        lookups.append((sets, table))

    shuffles = []
    p = _Parser(sec["shuffles"])
    p.eat("[")
    while not p.peek("]"):
        p.eat("(shuffle")
        group = p.number()
        unit = -p.number()          # "i-j" reads as i, then -j
        p.eat(",")
        ins = p.expr_list()
        p.eat(",")
        shs = p.expr_list()
        p.eat("),")
        if group == len(shuffles):
            shuffles.append([])
        if group != len(shuffles) - 1 or unit != len(shuffles[-1]):
            raise ValueError("shuffles out of order")
        shuffles[-1].append((ins, shs))

    return ConstraintSystem(
        text=text, num_fixed=int(head.group(1)), num_advice=int(head.group(2)),
        num_instance=int(head.group(3)), gates=gates,
        advice_queries=queries(sec["advice_queries"], "advice"),
        instance_queries=queries(sec["instance_queries"], "instance"),
        fixed_queries=queries(sec["fixed_queries"], "fixed"),
        permutation=[(t.lower(), int(c))
                     for c, t in _COLUMN.findall(sec["permutation"])],
        lookups=lookups, shuffles=shuffles)


def evaluate(e, fixed: list, advice: list, instance: list) -> int:
    """An expression at x, from the evaluations of its queries."""
    kind = e[0]
    if kind == "const":
        return e[1]
    if kind == "fixed":
        return fixed[e[1]]
    if kind == "advice":
        return advice[e[1]]
    if kind == "instance":
        return instance[e[1]]
    if kind == "neg":
        return -evaluate(e[1], fixed, advice, instance) % R
    if kind == "sum":
        return (evaluate(e[1], fixed, advice, instance)
                + evaluate(e[2], fixed, advice, instance)) % R
    if kind == "prod":
        return (evaluate(e[1], fixed, advice, instance)
                * evaluate(e[2], fixed, advice, instance)) % R
    if kind == "scaled":
        return evaluate(e[1], fixed, advice, instance) * e[2] % R
    raise ValueError(f"unknown expression {kind}")
