"""Multiopen shared types: queries, verifier-side MSM accumulators, Decider.

Mirrors halo2_proofs/src/poly/msm.rs (MSM/PairMSM) and
poly/multiopen.rs (ProverQuery/VerifierQuery/Decider).  Verifier MSMs are a
few dozen points — host big-int arithmetic, never device work.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from halo2_tpu_torch.curves import host
from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.pairing import bn254 as pairing

P = FR_MODULUS


@dataclass
class ProverQuery:
    point: int       # evaluation point (rotated x)
    rotation: int
    poly: object     # (16, n) coeff-form device limbs


@dataclass
class VerifierQuery:
    point: int
    rotation: int
    commitment: object  # host point | HostMSM
    eval: int


class HostMSM:
    """scalar/base accumulator (poly/msm.rs:6-70), host ints."""

    def __init__(self):
        self.pairs: list[tuple[int, object]] = []

    def scale(self, factor: int):
        self.pairs = [(s * factor % P, b) for s, b in self.pairs]

    def append_term(self, scalar: int, base):
        self.pairs.append((scalar % P, base))

    def add_msm(self, other: "HostMSM"):
        self.pairs.extend(other.pairs)

    def eval(self):
        # Jacobian Pippenger — the affine double-and-add paid one modular
        # inversion per group op (~20 ms/point in Python: most of the
        # verifier's wall-clock); this is ~50x faster at the ~40-80 point
        # sizes the verifier builds
        return host.msm_jacobian([b for _, b in self.pairs],
                                 [s for s, _ in self.pairs])


@dataclass
class PairMSM:
    left: HostMSM
    right: HostMSM


def decider_verify(params_verifier, pair: PairMSM) -> bool:
    """e(left, s_g2) * e(right, -g2) == 1 (poly/multiopen.rs:33-55)."""
    left = pair.left.eval()
    right = pair.right.eval()
    return pairing.pairing_check([
        (left, params_verifier.s_g2),
        (right, pairing.g2_neg(params_verifier.g2)),
    ])


class BatchVerifier:
    """Random-scaled accumulation of PairMSMs — ONE pairing check for many
    proofs (plonk/verifier.rs:62-111 BatchVerifier strategy)."""

    def __init__(self, seed: int | None = None):
        import random
        self._rng = random.Random(seed)
        self.left = HostMSM()
        self.right = HostMSM()
        self.ok = True

    def add(self, pair: PairMSM):
        r = self._rng.randrange(1, P)
        scaled_l = HostMSM()
        scaled_l.add_msm(pair.left)
        scaled_l.scale(r)
        self.left.add_msm(scaled_l)
        scaled_r = HostMSM()
        scaled_r.add_msm(pair.right)
        scaled_r.scale(r)
        self.right.add_msm(scaled_r)

    def finalize(self, params_verifier) -> bool:
        return self.ok and decider_verify(
            params_verifier, PairMSM(self.left, self.right))
