"""Developer tools, host only (no params, no keys, no device): MockProver
(mock.py), CircuitCost (cost.py), format_gates (gates.py) and
CircuitLayout (graph.py)."""

from halo2_tpu_torch.dev.cost import CircuitCost
from halo2_tpu_torch.dev.gates import format_gates
from halo2_tpu_torch.dev.graph import CircuitLayout, LayoutTracker
from halo2_tpu_torch.dev.mock import FailureLocation, MockProver, VerifyFailure

__all__ = ["CircuitCost", "CircuitLayout", "FailureLocation", "LayoutTracker",
           "MockProver", "VerifyFailure", "format_gates"]
