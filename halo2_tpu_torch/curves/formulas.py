"""RCB15 complete short-Weierstrass formulas, parameterized over field ops.

One source of truth for the group law, shared by:
  * the tests, which run it on a `Field` (ops = fq(device)) to check the
    plain point operations of curves/cuda_point.py, one field op at a time
  * csrc/point.cuh, which is this file transcribed to device functions
  * the Horner kernel (csrc/point_kernels.cu), which runs
    `double_levels` and `add_levels`: the same formulas scheduled as two
    levels of independent products, one product a thread of a lane's group

`ops` must provide mul/add/sub over (16, *B) limb arrays and `mul_by_9`
(bn254 b3 = 9, computed with additions).
"""

from __future__ import annotations


def mul_by_9(ops, a):
    a2 = ops.add(a, a)
    a4 = ops.add(a2, a2)
    a8 = ops.add(a4, a4)
    return ops.add(a8, a)


def add_complete(ops, p, q):
    """RCB15 Algorithm 7 (a=0, b3=9): complete projective + projective."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    F = ops
    t0 = F.mul(x1, x2)
    t1 = F.mul(y1, y2)
    t2 = F.mul(z1, z2)
    t3 = F.add(x1, y1)
    t4 = F.add(x2, y2)
    t3 = F.mul(t3, t4)
    t4 = F.add(t0, t1)
    t3 = F.sub(t3, t4)
    t4 = F.add(y1, z1)
    x3 = F.add(y2, z2)
    t4 = F.mul(t4, x3)
    x3 = F.add(t1, t2)
    t4 = F.sub(t4, x3)
    x3 = F.add(x1, z1)
    y3 = F.add(x2, z2)
    x3 = F.mul(x3, y3)
    y3 = F.add(t0, t2)
    y3 = F.sub(x3, y3)
    x3 = F.add(t0, t0)
    t0 = F.add(x3, t0)
    t2 = mul_by_9(F, t2)
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    y3 = mul_by_9(F, y3)
    x3 = F.mul(t4, y3)
    t2 = F.mul(t3, t1)
    x3 = F.sub(t2, x3)
    y3 = F.mul(y3, t0)
    t1 = F.mul(t1, z3)
    y3 = F.add(t1, y3)
    t0 = F.mul(t0, t3)
    z3 = F.mul(z3, t4)
    z3 = F.add(z3, t0)
    return (x3, y3, z3)


def add_mixed(ops, p, q_aff):
    """RCB15 Algorithm 8: projective + affine (q not the identity)."""
    x1, y1, z1 = p
    x2, y2 = q_aff
    F = ops
    t0 = F.mul(x1, x2)
    t1 = F.mul(y1, y2)
    t3 = F.add(x2, y2)
    t4 = F.add(x1, y1)
    t3 = F.mul(t3, t4)
    t4 = F.add(t0, t1)
    t3 = F.sub(t3, t4)
    t4 = F.mul(y2, z1)
    t4 = F.add(t4, y1)
    y3 = F.mul(x2, z1)
    y3 = F.add(y3, x1)
    x3 = F.add(t0, t0)
    t0 = F.add(x3, t0)
    t2 = mul_by_9(F, z1)
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    y3 = mul_by_9(F, y3)
    x3 = F.mul(t4, y3)
    t2 = F.mul(t3, t1)
    x3 = F.sub(t2, x3)
    y3 = F.mul(y3, t0)
    t1 = F.mul(t1, z3)
    y3 = F.add(t1, y3)
    t0 = F.mul(t0, t3)
    z3 = F.mul(z3, t4)
    z3 = F.add(z3, t0)
    return (x3, y3, z3)


def double_complete(ops, p):
    """RCB15 Algorithm 9 (a=0, b3=9): complete doubling."""
    x, y, z = p
    F = ops
    t0 = F.mul(y, y)
    z3 = F.add(t0, t0)
    z3 = F.add(z3, z3)
    z3 = F.add(z3, z3)
    t1 = F.mul(y, z)
    t2 = F.mul(z, z)
    t2 = mul_by_9(F, t2)
    x3 = F.mul(t2, z3)
    y3 = F.add(t0, t2)
    z3 = F.mul(t1, z3)
    t1 = F.add(t2, t2)
    t2 = F.add(t1, t2)
    t0 = F.sub(t0, t2)
    y3 = F.mul(t0, y3)
    y3 = F.add(x3, y3)
    t1 = F.mul(x, y)
    x3 = F.mul(t0, t1)
    x3 = F.add(x3, x3)
    return (x3, y3, z3)


# The level schedule of the Horner kernel.  Each formula is two levels of
# independent products, computed side by side; the additions before and
# between the levels are made by every thread.  Every field operation
# returns the canonical value, so any schedule of the same operations gives
# the same limbs as the formulas above.

def _level(ops, pairs):
    return [ops.mul(a, b) for a, b in pairs]


def double_levels(ops, p):
    """double_complete as levels of 4 and 4 products."""
    x, y, z = p
    F = ops
    t0, t1, t2, xy = _level(F, [(y, y), (y, z), (z, z), (x, y)])
    t2 = mul_by_9(F, t2)
    z3 = F.add(t0, t0)
    z3 = F.add(z3, z3)
    z3 = F.add(z3, z3)
    y3 = F.add(t0, t2)
    t0 = F.sub(t0, F.add(F.add(t2, t2), t2))
    xa, z3, ya, xb = _level(F, [(t2, z3), (t1, z3), (t0, y3), (t0, xy)])
    return (F.add(xb, xb), F.add(xa, ya), z3)


def add_levels(ops, p, q):
    """add_complete as levels of 6 and 6 products."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    F = ops
    t0, t1, t2, m3, m4, m5 = _level(F, [
        (x1, x2), (y1, y2), (z1, z2), (F.add(x1, y1), F.add(x2, y2)),
        (F.add(y1, z1), F.add(y2, z2)), (F.add(x1, z1), F.add(x2, z2))])
    t3 = F.sub(m3, F.add(t0, t1))
    t4 = F.sub(m4, F.add(t1, t2))
    y3 = F.sub(m5, F.add(t0, t2))
    t0 = F.add(F.add(t0, t0), t0)
    t2 = mul_by_9(F, t2)
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    y3 = mul_by_9(F, y3)
    xa, xb, ya, yb, za, zb = _level(F, [
        (t4, y3), (t3, t1), (y3, t0), (t1, z3), (t0, t3), (z3, t4)])
    return (F.sub(xb, xa), F.add(yb, ya), F.add(zb, za))
