"""Gate pretty-printer (dev/gates.rs analogue)."""

from __future__ import annotations

from halo2_tpu_torch.plonk.circuit import ConstraintSystem


def format_gates(cs: ConstraintSystem) -> str:
    out = []
    for gate in cs.gates:
        out.append(f"gate {gate.name}:")
        for name, poly in zip(gate.constraint_names, gate.polys):
            label = f" [{name}]" if name else ""
            out.append(f"  deg{poly.degree()}{label}: {poly.identifier()}")
    return "\n".join(out)
