"""The work of an MSM, counted the same whatever implements it: n points
under 254-bit scalars, a windowed bucket method with signed digits (window
c: ceil(254 / c) windows, each n additions into 2^(c-1) buckets and 2^c
additions to sum the buckets), at the window that needs the fewest
additions; each addition priced as a mixed addition (7 multiplications and
4 squarings in Fq: 11 products) of 264 multiply-adds a product (a 254-bit
CIOS Montgomery product over 16-bit limbs, the port's kernel table).  The
doublings that combine the windows are left out: a lower bound of the
work."""

from __future__ import annotations

SCALAR_BITS = 254
PRODUCTS_PER_ADD = 11
MADS_PER_PRODUCT = 264


def msm_additions(n: float) -> float:
    return min(-(-SCALAR_BITS // c) * (n + (1 << c)) for c in range(1, 25))


def msm_mads(n: float) -> float:
    """Integer multiply-adds of one MSM over n points."""
    return msm_additions(n) * PRODUCTS_PER_ADD * MADS_PER_PRODUCT
