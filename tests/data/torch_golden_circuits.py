"""The port's circuits for the proof records of torch_golden_args.json and
torch_golden_multi.json, by the record's key.  Imports the port only, so
that chip_smoke.py (which runs without JAX) and the tests read the same
map."""

from halo2_tpu_torch.circuit import FlatFloorPlanner
from halo2_tpu_torch.circuits import (AllArgsCircuit, LookupAnyCircuit,
                                      LookupShuffleCircuit, PlonkApiCircuit,
                                      RangeCheckCircuit, SimpleCircuit)


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


def multi_circuits(name: str, rec: dict):
    """(empty circuit for keygen, one circuit with its witness per proof)
    of the torch_golden_multi.json proof record `name`."""
    proofs = len(rec["instances"])
    if name in ("e2e_multi_gwc", "simple_shplonk"):
        return SimpleCircuit(), [SimpleCircuit(a, b)
                                 for a, b in rec["witnesses"]]
    if name == "lookup_any_shplonk":
        return LookupAnyCircuit(), [LookupAnyCircuit(LookupAnyCircuit.VALUES)]
    if name == "lookup_shuffle_shplonk":
        circuit, _ = argument_circuit("lookup_shuffle", rec["k"])
        return LookupShuffleCircuit(), [circuit]
    if name.startswith("plonk_api_multi_"):
        return PlonkApiCircuit(), [PlonkApiCircuit(PlonkApiCircuit.A_VALUE)
                                   for _ in range(proofs)]
    raise ValueError(f"unknown multi-proof record {name!r}")
