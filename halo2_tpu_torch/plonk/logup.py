"""Logup (logarithmic-derivative) lookup argument — descriptors & chunking.

Mirrors halo2_proofs/src/plonk/logup.rs: an argument has one
shared table and multiple input sets; the first set shares its degree budget
with the table, extra sets are table-free (logup.rs:14-61).  `ArgumentTracer`
greedily packs the inputs registered against one table into sets under
global_degree - 2 (logup.rs:85-176).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class LogupArgument:
    name: str
    table_expressions: list
    input_expressions_sets: list  # list[list[list[Expression]]]

    def required_degree(self) -> int:
        input_degree = 1
        for inputs_set in self.input_expressions_sets:
            for inputs in inputs_set:
                assert len(inputs) == len(self.table_expressions)
                for expr in inputs:
                    input_degree = max(input_degree, expr.degree())
        table_degree = max([e.degree() for e in self.table_expressions] + [1])
        return max(4, 2 + input_degree + table_degree)

    def identifier(self) -> str:
        tid = "".join(t.identifier() for t in self.table_expressions)
        iid = ";".join(",".join(e.identifier() for e in inputs)
                       for s in self.input_expressions_sets for inputs in s)
        return f"logup({tid}|{iid})"


@dataclass
class ArgumentTracer:
    name: str
    table_expressions: list
    input_expression_set: list = field(default_factory=list)  # [(name, exprs)]

    def table_identifier(self) -> str:
        return "".join(t.identifier() for t in self.table_expressions)

    def required_degree(self) -> int:
        input_degree = 1
        for _, inputs in self.input_expression_set:
            assert len(inputs) == len(self.table_expressions)
            for expr in inputs:
                input_degree = max(input_degree, expr.degree())
        table_degree = max([e.degree() for e in self.table_expressions] + [1])
        return max(4, 2 + input_degree + table_degree)

    def chunks(self, global_degree: int) -> LogupArgument:
        """Greedy set packing (logup.rs:85-176)."""
        assert global_degree > 2
        max_degree = global_degree - 2
        table_degree = max([e.degree() for e in self.table_expressions] + [1])

        base_set = [list(self.input_expression_set[0][1])]
        extra_sets: list[list[list]] = []

        def set_deg_sum(s):
            return sum(max([v.degree() for v in e] + [1]) for e in s)

        for _, inputs in self.input_expression_set[1:]:
            new_deg = max([v.degree() for v in inputs] + [1])
            if table_degree + set_deg_sum(base_set) + new_deg <= max_degree:
                base_set.append(list(inputs))
                continue
            placed = False
            for s in extra_sets:
                if set_deg_sum(s) + new_deg <= max_degree:
                    s.append(list(inputs))
                    placed = True
                    break
            if not placed:
                extra_sets.append([list(inputs)])

        sets = [base_set] + extra_sets
        assert sum(len(s) for s in sets) == len(self.input_expression_set)
        return LogupArgument(self.name, list(self.table_expressions), sets)
