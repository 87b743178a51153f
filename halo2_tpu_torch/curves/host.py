"""Host-side (pure Python big-int) BN254 G1/G2 arithmetic — the golden model.

Used for: SRS setup scalar math, verifier-side small point ops, and as the
differential-test oracle for the device (limb-vector) kernels in
`halo2_tpu_torch.curves.g1`.  The reference obtains this from the external
`pairing_bn256` crate (halo2_proofs/Cargo.toml:34); here the
golden model is exact integer arithmetic.

Points are `(x, y)` tuples of Python ints, or `None` for the identity.
"""

from __future__ import annotations

from halo2_tpu_torch.fields.bn254 import FQ_MODULUS, FR_MODULUS

Q = FQ_MODULUS
R = FR_MODULUS

G1_GEN = (1, 2)
B = 3


def is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B) % Q == 0


def neg(p):
    if p is None:
        return None
    x, y = p
    return (x, (-y) % Q)


def add(p, q):
    """Affine addition with full special-case handling."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        return double(p)
    lam = (y2 - y1) * pow(x2 - x1, Q - 2, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def double(p):
    if p is None:
        return None
    x, y = p
    if y == 0:
        return None
    lam = 3 * x * x * pow(2 * y, Q - 2, Q) % Q
    x3 = (lam * lam - 2 * x) % Q
    y3 = (lam * (x - x3) - y) % Q
    return (x3, y3)


def mul(p, k: int):
    """Scalar multiplication (double-and-add)."""
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = add(acc, p)
        p = double(p)
        k >>= 1
    return acc


def msm(points, scalars):
    """Naive host MSM for testing: sum scalar_i * P_i."""
    acc = None
    for p, s in zip(points, scalars):
        acc = add(acc, mul(p, s))
    return acc


def random_point(rng):
    """A uniformly random G1 point (via random scalar times the generator)."""
    return mul(G1_GEN, rng.randrange(1, R))


# -- Jacobian arithmetic (no per-op inversions) ------------------------------
#
# The affine ops above pay one modular inverse per add/double — fine as a
# golden model, far too slow as the CPU-backend fallback compute path (the
# test suite's tiny MSMs and SRS setups run here instead of compiling the
# giant device programs; see msm.msm / Params.unsafe_setup).  Jacobian:
# (X, Y, Z) with x = X/Z^2, y = Y/Z^3; identity is Z = 0.

JAC_IDENT = (1, 1, 0)


def jac_from_affine(p):
    return JAC_IDENT if p is None else (p[0], p[1], 1)


def jac_double(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return JAC_IDENT
    A = X * X % Q
    B = Y * Y % Q
    C = B * B % Q
    D = 2 * ((X + B) * (X + B) - A - C) % Q
    E = 3 * A % Q
    F = E * E % Q
    X3 = (F - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y * Z % Q
    return (X3, Y3, Z3)


def jac_add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    if U1 == U2:
        if S1 != S2:
            return JAC_IDENT
        return jac_double(p)
    H = (U2 - U1) % Q
    I = 4 * H * H % Q
    J = H * I % Q
    r = 2 * (S2 - S1) % Q
    V = U1 * I % Q
    X3 = (r * r - J - 2 * V) % Q
    Y3 = (r * (V - X3) - 2 * S1 * J) % Q
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % Q * H % Q
    return (X3, Y3, Z3)


def jac_to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zinv = pow(Z, Q - 2, Q)
    zinv2 = zinv * zinv % Q
    return (X * zinv2 % Q, Y * zinv2 * zinv % Q)


_FIXED_BASE_TABLES: dict = {}


def fixed_base_tables(base, c: int = 8, bits: int = 256):
    """Per-window multiples table for fixed-base scalar mul:
    table[w][d] = d * 2^(c*w) * base (Jacobian), d in [0, 2^c)."""
    key = (base, c, bits)
    tab = _FIXED_BASE_TABLES.get(key)
    if tab is not None:
        return tab
    windows = (bits + c - 1) // c
    tab = []
    b = jac_from_affine(base)
    for _ in range(windows):
        row = [JAC_IDENT]
        for d in range(1, 1 << c):
            row.append(jac_add(row[-1], b))
        tab.append(row)
        for _ in range(c):
            b = jac_double(b)
    _FIXED_BASE_TABLES[key] = tab
    return tab


def fixed_base_affine(base, c: int = 8, bits: int = 256):
    """fixed_base_tables(base) in affine form, d = 0 left out:
    out[w][d - 1] = d * 2^(c*w) * base as (x, y), d in [1, 2^c).  One
    inversion for all the Z's (Montgomery's trick), not one a point."""
    jac = [p for row in fixed_base_tables(base, c, bits) for p in row[1:]]
    prefix, acc = [], 1
    for _, _, z in jac:
        prefix.append(acc)
        acc = acc * z % Q
    inv = pow(acc, Q - 2, Q)
    flat = [None] * len(jac)
    for i in range(len(jac) - 1, -1, -1):
        x, y, z = jac[i]
        zinv = inv * prefix[i] % Q
        inv = inv * z % Q
        zinv2 = zinv * zinv % Q
        flat[i] = (x * zinv2 % Q, y * zinv2 * zinv % Q)
    per = (1 << c) - 1
    return [flat[w * per:(w + 1) * per] for w in range(len(flat) // per)]


def fixed_base_mul(tables, k: int, c: int = 8):
    """k * base using a precomputed fixed_base_tables(base)."""
    acc = JAC_IDENT
    w = 0
    while k and w < len(tables):
        d = k & ((1 << c) - 1)
        if d:
            acc = jac_add(acc, tables[w][d])
        k >>= c
        w += 1
    return acc


def msm_jacobian(points, scalars, c: int = 8):
    """Host Pippenger MSM (bucket method), exact bigint math.  points:
    affine (x, y) or None; scalars: canonical ints.  Returns affine or
    None.  This is the CPU-backend fallback for small device MSMs."""
    n = len(points)
    if n == 0:
        return None
    max_bits = max((s.bit_length() for s in scalars), default=1)
    windows = max((max_bits + c - 1) // c, 1)
    acc = JAC_IDENT
    for w in reversed(range(windows)):
        if w != windows - 1:
            acc = jac_double_times(acc, c)
        buckets = {}
        shift = c * w
        for p, s in zip(points, scalars):
            if p is None:
                continue
            d = (s >> shift) & ((1 << c) - 1)
            if d:
                jp = (p[0], p[1], 1)
                buckets[d] = jac_add(buckets[d], jp) if d in buckets else jp
        # total_w = sum_d d * B_d: walk d descending, `running` holds the
        # suffix sum; between consecutive occupied buckets the suffix
        # contributes (d_prev - d) * running
        running = JAC_IDENT
        total = JAC_IDENT
        last = None
        for d in sorted(buckets, reverse=True):
            if last is not None:
                total = _jac_add_times(total, running, last - d)
            running = jac_add(running, buckets[d])
            last = d
        if last is not None:
            total = _jac_add_times(total, running, last)
        acc = jac_add(acc, total)
    return jac_to_affine(acc)


def jac_double_times(p, times: int):
    for _ in range(times):
        p = jac_double(p)
    return p


def _jac_add_times(acc, p, times: int):
    """acc + times * p (double-and-add on p)."""
    while times:
        if times & 1:
            acc = jac_add(acc, p)
        p = jac_double(p)
        times >>= 1
    return acc
