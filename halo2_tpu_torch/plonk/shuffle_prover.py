"""Shuffle prover-side computation: compression and grand products.

Mirrors halo2_proofs/src/plonk/shuffle/prover.rs: one grand product per
group with unit challenges beta^1, beta^2, ...; z via one batch inversion
of the shuffle-side product and a prefix-product scan.
"""

from __future__ import annotations

import os

import torch

from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.plonk.expr_eval import ExprCtx, compress_exprs

P = FR_MODULUS
# the reference's `sanity-checks` feature: the grand product's closure is
# read back and checked (one scalar from the device a shuffle group)
_SANITY = os.environ.get("HALO2_TPU_SANITY_CHECKS", "") == "1"


def compress(group, lag_ctx: ExprCtx, theta):
    """Returns (input_cols list, shuffle_cols list), each (16, n)."""
    inputs = [compress_exprs(u.input_expressions, lag_ctx, theta)
              for u in group.units]
    shuffles = [compress_exprs(u.shuffle_expressions, lag_ctx, theta)
                for u in group.units]
    return inputs, shuffles


def product_ratio(F, input_cols, shuffle_cols, beta):
    """prod_i (a_i + beta^{i+1}) / prod_i (s_i + beta^{i+1}), (16, n)."""
    chal = beta
    num, den = None, None
    for a_col, s_col in zip(input_cols, shuffle_cols):
        a = F.add(a_col, chal)
        s = F.add(s_col, chal)
        num = a if num is None else F.mul(num, a)
        den = s if den is None else F.mul(den, s)
        chal = F.mul(chal, beta)
    return F.mul(num, F.batch_inverse(den))


def z_from_ratio(F, ratio):
    """z[0] = 1; z[i+1] = z[i] * ratio[i]."""
    pref = F.prefix_mul(ratio)
    n = ratio.shape[-1]
    return torch.cat([F.ones((1,)), pref[:, : n - 1]], dim=1)


def commit_product(domain, cs, input_cols, shuffle_cols, beta: int, rng):
    """Grand product z for one shuffle group (Lagrange, blinded); the
    caller commits it."""
    F = domain.F
    n = domain.n
    bf = cs.blinding_factors()
    ratio = product_ratio(F, input_cols, shuffle_cols, F.encode_scalar(beta))
    z = z_from_ratio(F, ratio)
    if _SANITY:
        # the grand product must close to 1 at the last active row
        # (shuffle/prover.rs:159-194 sanity-checks feature)
        zu = F.decode_scalar(z[:, n - (bf + 1)])
        if zu != 1:
            raise AssertionError(f"shuffle grand product != 1: {zu}")
    z[:, n - bf:] = F.encode([rng.randrange(P) for _ in range(bf)])
    return z
