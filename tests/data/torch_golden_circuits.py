"""The port's circuit for each proof record of torch_golden_args.json, by
the record's key.  Imports the port only, so that chip_smoke.py (which runs
without JAX) and the tests read the same map."""

from halo2_tpu_torch.circuit import FlatFloorPlanner
from halo2_tpu_torch.circuits import (AllArgsCircuit, LookupShuffleCircuit,
                                      RangeCheckCircuit)


def argument_circuit(name: str, k: int):
    """(circuit with its witness, floor planner) of the record `name`
    ("lookup_shuffle", "range_check" or "all_args") for a 2^k-row domain."""
    if name == "lookup_shuffle":
        return LookupShuffleCircuit(LookupShuffleCircuit.VALS_A,
                                    LookupShuffleCircuit.VALS_B), None
    if name == "range_check":
        return RangeCheckCircuit(RangeCheckCircuit.VALUES), None
    if name == "all_args":
        return AllArgsCircuit(AllArgsCircuit.usable_rows(k)), FlatFloorPlanner
    raise ValueError(f"unknown argument circuit {name!r}")
