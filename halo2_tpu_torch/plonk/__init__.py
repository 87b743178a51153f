from halo2_tpu_torch.plonk.circuit import (
    Circuit,
    Column,
    ConstraintSystem,
    Expression,
    Rotation,
    Selector,
)

# NOTE: no "keygen" alias here — the submodule of the same name would
# shadow it; use halo2_tpu_torch.plonk.keygen.keygen.
_LAZY = {
    "Assigned": ("halo2_tpu_torch.plonk.assigned", "Assigned"),
    "ProvingKey": ("halo2_tpu_torch.plonk.keygen", "ProvingKey"),
    "VerifyingKey": ("halo2_tpu_torch.plonk.keygen", "VerifyingKey"),
    "create_proof": ("halo2_tpu_torch.plonk.prover", "create_proof"),
    "verify_proof": ("halo2_tpu_torch.plonk.verifier", "verify_proof"),
    # typed errors (plonk/error.rs analogue)
    "Halo2Error": ("halo2_tpu_torch.plonk.error", "Halo2Error"),
    "SynthesisError": ("halo2_tpu_torch.plonk.error", "SynthesisError"),
    "InvalidInstancesError": ("halo2_tpu_torch.plonk.error", "InvalidInstancesError"),
    "ConstraintSystemFailure": ("halo2_tpu_torch.plonk.error", "ConstraintSystemFailure"),
    "BoundsFailure": ("halo2_tpu_torch.plonk.error", "BoundsFailure"),
    "OpeningError": ("halo2_tpu_torch.plonk.error", "OpeningError"),
    "TranscriptError": ("halo2_tpu_torch.plonk.error", "TranscriptError"),
    "NotEnoughRowsAvailable": ("halo2_tpu_torch.plonk.error", "NotEnoughRowsAvailable"),
    "InstanceTooLarge": ("halo2_tpu_torch.plonk.error", "InstanceTooLarge"),
    "NotEnoughColumnsForConstants": ("halo2_tpu_torch.plonk.error",
                                     "NotEnoughColumnsForConstants"),
    "ColumnNotInPermutation": ("halo2_tpu_torch.plonk.error", "ColumnNotInPermutation"),
    "NotEnoughRowsForRangeCheck": ("halo2_tpu_torch.plonk.error",
                                   "NotEnoughRowsForRangeCheck"),
}


def __getattr__(name):
    # lazy to break the circular import plonk -> keygen -> circuit-layer ->
    # plonk.circuit
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
