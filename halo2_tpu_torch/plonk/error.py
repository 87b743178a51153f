"""Typed proving/synthesis errors — the `plonk::Error` enum analogue
(halo2_proofs/src/plonk/error.rs:11-42).

Every variant subclasses ValueError so existing `except ValueError` /
`pytest.raises(ValueError)` call sites keep working; catching the specific
type gives the reference's error discrimination.
"""

from __future__ import annotations


class Halo2Error(ValueError):
    """Base class for all halo2_tpu proving errors (Error enum)."""


class SynthesisError(Halo2Error):
    """General synthesis error (Error::Synthesis) — e.g. a witness value
    was not provided during proving synthesis."""

    def __init__(self, msg: str = "General synthesis error"):
        super().__init__(msg)


class InvalidInstancesError(Halo2Error):
    """Provided instances do not match the circuit
    (Error::InvalidInstances)."""

    def __init__(self, msg: str = "Provided instances do not match the circuit"):
        super().__init__(msg)


class ConstraintSystemFailure(Halo2Error):
    """The constraint system is not satisfied
    (Error::ConstraintSystemFailure)."""

    def __init__(self, msg: str = "The constraint system is not satisfied"):
        super().__init__(msg)


class BoundsFailure(Halo2Error):
    """Out-of-bounds index passed to a backend (Error::BoundsFailure)."""

    def __init__(self, msg: str = "An out-of-bounds index was passed to the backend"):
        super().__init__(msg)


class OpeningError(Halo2Error):
    """Multi-opening proof was invalid (Error::Opening)."""

    def __init__(self, msg: str = "Multi-opening proof was invalid"):
        super().__init__(msg)


class TranscriptError(Halo2Error):
    """Transcript (de)serialization error (Error::Transcript)."""


class NotEnoughRowsAvailable(Halo2Error):
    """k is too small for the given circuit
    (Error::NotEnoughRowsAvailable { current_k })."""

    def __init__(self, current_k: int):
        self.current_k = current_k
        super().__init__(
            f"k = {current_k} is too small for the given circuit. "
            "Try using a larger value of k")


class InstanceTooLarge(Halo2Error):
    """Instance vectors are larger than the circuit
    (Error::InstanceTooLarge)."""

    def __init__(self, msg: str = "Instance vectors are larger than the circuit"):
        super().__init__(msg)


class NotEnoughColumnsForConstants(Halo2Error):
    """Circuit requires global constants but no constants column has space
    (Error::NotEnoughColumnsForConstants)."""

    def __init__(self,
                 msg: str = "Too few fixed columns are enabled for global "
                            "constants usage"):
        super().__init__(msg)


class ColumnNotInPermutation(Halo2Error):
    """A copy constraint names a column outside the permutation
    (Error::ColumnNotInPermutation)."""

    def __init__(self, column):
        self.column = column
        super().__init__(
            f"Column {column!r} must be included in the permutation. "
            "Help: try applying `meta.enable_equality` on the column")


class NotEnoughRowsForRangeCheck(Halo2Error):
    """Not enough rows for auxiliary range values
    (Error::NotEnoughRowsForRangeCheck)."""

    def __init__(self,
                 msg: str = "Not enough rows for auxiliary range values. "
                            "Try using a larger value of k"):
        super().__init__(msg)
