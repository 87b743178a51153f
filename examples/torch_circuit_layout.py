#!/usr/bin/env python3
"""Render a circuit's layout to SVG on the port (the reference's
examples/circuit-layout.rs, through halo2_tpu_torch/dev/graph.py): the
two-chip FieldCircuit of examples/torch_two_chip_example.py at k = 5.
Host only, no card.

    python3 examples/torch_circuit_layout.py [out.svg]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.torch_two_chip_example import FieldCircuit  # noqa: E402
from halo2_tpu_torch.dev import CircuitLayout  # noqa: E402


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "layout.svg"
    svg = CircuitLayout().render(FieldCircuit(), k=5, path=path)
    print(f"wrote {path} ({len(svg)} bytes)")


if __name__ == "__main__":
    main()
