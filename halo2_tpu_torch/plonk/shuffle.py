"""Shuffle argument descriptors & degree-driven grouping.

Mirrors halo2_proofs/src/plonk/shuffle.rs: shuffle units are
greedily packed into groups with degree-sum <= global_degree - 2; each group
gets ONE grand product with challenges beta^1, beta^2, ... per member
(shuffle.rs:70-103)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ShuffleUnit:
    name: str
    input_expressions: list
    shuffle_expressions: list

    def degree(self) -> int:
        assert len(self.input_expressions) == len(self.shuffle_expressions)
        input_degree = max([e.degree() for e in self.input_expressions] + [1])
        shuffle_degree = max([e.degree() for e in self.shuffle_expressions] + [1])
        return max(shuffle_degree, input_degree)

    def required_degree(self) -> int:
        return 2 + self.degree()

    def identifier(self) -> str:
        i = ",".join(e.identifier() for e in self.input_expressions)
        s = ",".join(e.identifier() for e in self.shuffle_expressions)
        return f"shuffle({i}|{s})"


@dataclass
class ShuffleGroup:
    units: list

    def degree_sum(self) -> int:
        return sum(u.degree() for u in self.units)

    def required_degree(self) -> int:
        return 2 + self.degree_sum()

    def identifier(self) -> str:
        return "+".join(u.identifier() for u in self.units)


def chunk(tracer: list, global_degree: int) -> list:
    """Greedy first-fit grouping (shuffle.rs:70-103)."""
    assert tracer, "shuffle tracer is empty"
    assert global_degree > 2
    max_degree = global_degree - 2
    groups = [ShuffleGroup([tracer[0]])]
    for unit in tracer[1:]:
        new_deg = unit.degree()
        for group in groups:
            if group.degree_sum() + new_deg <= max_degree:
                group.units.append(unit)
                break
        else:
            groups.append(ShuffleGroup([unit]))
    assert sum(len(g.units) for g in groups) == len(tracer)
    return groups
