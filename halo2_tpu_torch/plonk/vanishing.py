"""Vanishing argument (prover side).

Mirrors halo2_proofs/src/plonk/vanishing/prover.rs:
  * random blinding polynomial committed before y (product-of-randoms
    construction approximated by direct uniform sampling — the reference's
    product construction is an entropy-hygiene detail, prover.rs:41-68)
  * construct: divide h by t(X) on the coset, extended iFFT, split into
    n-sized pieces, commit each (prover.rs:71-110)
  * evaluate: fold pieces by x^n, evaluate random poly (prover.rs:112-134)
"""

from __future__ import annotations

import numpy as np
from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.fields.limbs import N_LIMBS
from halo2_tpu_torch.ntt.ntt import take
from halo2_tpu_torch.poly.arith import eval_poly
from halo2_tpu_torch.poly.domain import Polynomial

P = FR_MODULUS


class VanishingProver:
    def __init__(self, params, domain, rng):
        self.params = params
        self.domain = domain
        self.random_poly = self._random_coeffs(rng, domain)
        self.random_commitment = params.commit_many_affine(
            [self.random_poly])[0]

    @staticmethod
    def _random_coeffs(rng, domain):
        """(16, n) Montgomery limbs of n uniform-mod-p blinding coeffs.

        One draw of 64 n random bytes, as 2n 32-byte rows lo_0 .. lo_{n-1},
        hi_0 .. hi_{n-1}, written into the staging buffer as drawn; the
        rows go up as they are and one decode on the device masks each to
        253 bits (< p) and makes its limbs; then lo + hi*2^253 mod p.  The
        sum is uniform over [0, 2^506) before reduction, so the mod-p bias
        is O(2^-253).  No host pass over the bytes but the draw."""
        F, n = domain.F, domain.n
        # chunked draw: one randbytes call of n*64 bytes overflows
        # getrandbits' C-int bit count at n = 2^22
        chunk = 1 << 24

        def draw(rows):
            for off in range(0, n * 64, chunk):
                size = min(chunk, n * 64 - off)
                rows[off:off + size] = np.frombuffer(rng.randbytes(size),
                                                     dtype=np.uint8)
        both = F.decode_le_rows(draw, 1, 2 * n, mask=True)[0][:, 0, :]
        lo, hi = both[:, :n], both[:, n:]
        return F.add(lo, F.mul(hi, F.encode_scalar(pow(2, 253, P))))

    def construct(self, h_ext, mesh=None, axis="x"):
        """h numerator on extended coset -> (pieces (16, qd, n), commitments).
        h_ext: the (16, ext_n) values, or with a mesh the row-sharded
        ShardedArray of the sharded evaluator, alone or in a one-element
        list handing them over, so that they are let go once divided.
        With a mesh, the extended iNTT is the four-step transform over
        it."""
        domain = self.domain
        h_ext = take(h_ext)
        h = domain.divide_by_vanishing_poly(Polynomial(h_ext, "extended"))
        del h_ext
        h_coeff = domain.extended_to_coeff(h, mesh, axis)    # (16, n*qd)
        qd = domain.quotient_poly_degree
        pieces = h_coeff.reshape(N_LIMBS, qd, domain.n)
        commitments = self.params.commit_many_affine(
            [pieces[:, i, :] for i in range(qd)])
        return pieces, commitments

    def fold_h(self, pieces, xn: int):
        """h_poly = fold pieces by x^n (vanishing/prover.rs:112-134)."""
        F = self.domain.F
        xn_l = F.encode_scalar(xn)
        qd = pieces.shape[1]
        acc = pieces[:, qd - 1, :]
        for i in range(qd - 2, -1, -1):
            acc = F.add(F.mul(acc, xn_l), pieces[:, i, :])
        return acc

    def evaluate(self, pieces, x: int, xn: int):
        """h_poly = fold pieces by x^n; returns (h_poly coeffs, random_eval)."""
        h_poly = self.fold_h(pieces, xn)
        random_eval = eval_poly(self.random_poly, x)
        return h_poly, random_eval
