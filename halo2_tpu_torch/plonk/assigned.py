"""`Assigned<F>` — deferred-division cell values + batch inversion.

Mirrors halo2_proofs/src/plonk/assigned.rs:11-17 (the
Zero/Trivial/Rational enum) and poly.rs:148-173 (`batch_invert_assigned`):
gadget code may assign `a/b` without paying a field inversion per cell; the
backend collects every nontrivial denominator and resolves them all with
ONE modular inversion (Montgomery's batch-inversion trick) at the end of
synthesis.

Representation: a single (num, den) pair over canonical ints.
  den == 1 -> Trivial(num)      den == 0 -> the value 0  (a denominator of
  zero maps to an assigned value of zero, assigned.rs:9)
Arithmetic follows assigned.rs's `match` arms exactly, including the
x/0-maps-to-zero short circuits in add/sub.

The batch inversion runs on HOST: synthesis itself is host-side Python, so
a device round-trip for the handful of rational cells would cost more than
the 3 mulmods/value + single `pow` it saves.
"""

from __future__ import annotations

from halo2_tpu_torch.fields.bn254 import FR_MODULUS

P = FR_MODULUS


class Assigned:
    """A cell value stored as a fraction num/den (canonical ints < p)."""

    __slots__ = ("num", "den")

    def __init__(self, num: int, den: int = 1):
        self.num = num % P
        self.den = den % P

    # -- constructors (assigned.rs:20-36 From impls) ----------------------
    @classmethod
    def zero(cls) -> "Assigned":
        return cls(0, 1)

    @classmethod
    def trivial(cls, v: int) -> "Assigned":
        return cls(v, 1)

    @classmethod
    def rational(cls, num: int, den: int) -> "Assigned":
        return cls(num, den)

    # -- predicates -------------------------------------------------------
    def is_zero(self) -> bool:
        # x/0 maps to zero (assigned.rs:9)
        return self.num == 0 or self.den == 0

    def is_trivial(self) -> bool:
        return self.den == 1

    # -- arithmetic (assigned.rs Neg/Add/Sub/Mul impls) -------------------
    def __neg__(self) -> "Assigned":
        return Assigned((-self.num) % P, self.den)

    def __add__(self, other) -> "Assigned":
        other = _coerce(other)
        # one side zero (incl. the x/0 arm) -> the other side unchanged
        if self.is_zero():
            return other
        if other.is_zero():
            return self
        if self.den == other.den:
            # trivial+trivial keeps den (=1) — and equal-denominator
            # rationals add numerators directly
            return Assigned((self.num + other.num) % P, self.den)
        return Assigned((self.num * other.den + other.num * self.den) % P,
                        (self.den * other.den) % P)

    __radd__ = __add__

    def __sub__(self, other) -> "Assigned":
        return self + (-_coerce(other))

    def __rsub__(self, other) -> "Assigned":
        return _coerce(other) + (-self)

    def __mul__(self, other) -> "Assigned":
        other = _coerce(other)
        return Assigned((self.num * other.num) % P,
                        (self.den * other.den) % P)

    __rmul__ = __mul__

    def invert(self) -> "Assigned":
        """Multiplicative inverse: swap the fraction (assigned.rs invert)."""
        return Assigned(self.den, self.num)

    # -- resolution -------------------------------------------------------
    def evaluate(self) -> int:
        """Eager per-cell resolution (one `pow`); prefer the batch path."""
        if self.den == 0:
            return 0
        if self.den == 1:
            return self.num
        return self.num * pow(self.den, P - 2, P) % P

    def __int__(self) -> int:
        return self.evaluate()

    def __repr__(self) -> str:
        if self.den == 1:
            return f"Assigned.trivial({self.num:#x})"
        return f"Assigned.rational({self.num:#x}, {self.den:#x})"


def _coerce(v) -> Assigned:
    if isinstance(v, Assigned):
        return v
    return Assigned(int(v), 1)


def batch_invert(values: list[int]) -> list[int]:
    """Inverses of `values` with ONE modular exponentiation (Montgomery's
    trick, the host analogue of arithmetic.rs:840-844): prefix products,
    invert the total, back-substitute.  Zeros map to zero (matching
    batch_invert's treatment of unavailable inverses)."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * (v if v else 1) % P
    inv = pow(prefix[n], P - 2, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = values[i]
        if v:
            out[i] = inv * prefix[i] % P
            inv = inv * v % P
    return out


def resolve_deferred(deferred: list[tuple], write) -> None:
    """Resolve deferred rational assignments (poly.rs:148-173
    batch_invert_assigned): `deferred` is a list of (key..., num, den)
    tuples; for each, `write(*key, value)` is called with the resolved
    canonical value.  Exactly ONE `pow` total, regardless of cell count."""
    if not deferred:
        return
    invs = batch_invert([d[-1] for d in deferred])
    for d, dinv in zip(deferred, invs):
        *key, num, _ = d
        write(*key, num * dinv % P)
