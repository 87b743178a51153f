"""BN254 in plain Python integers: the scalar field Fr, the base field Fq
and the group G1 (y^2 = x^3 + 3, generator (1, 2)), with the compressed
32-byte point encoding of halo2's bn256 proofs (x little-endian, the parity
of y in bit 255, the identity all zeros).

Points are affine pairs (x, y) or None for the identity; sums are taken in
Jacobian coordinates (X, Y, Z) with Z == 0 for the identity."""

from __future__ import annotations

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
B = 3
G1 = (1, 2)

# Fr: r - 1 = 2^28 * t; 7 generates Fr^*
TWO_ADICITY = 28
GENERATOR = 7
ROOT_OF_UNITY = pow(GENERATOR, (R - 1) >> TWO_ADICITY, R)
# the coset shift of the permutation argument's columns: g^(2^S)
DELTA = pow(GENERATOR, 1 << TWO_ADICITY, R)


def inv(a: int) -> int:
    return pow(a % R, R - 2, R)


def omega(k: int) -> int:
    """The primitive 2^k-th root of unity of the domain of 2^k rows."""
    return pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - k), R)


# -- G1 -----------------------------------------------------------------------

_INF = (1, 1, 0)


def _jac(p):
    return _INF if p is None else (p[0], p[1], 1)


def _double(p):
    x, y, z = p
    if z == 0 or y == 0:
        return _INF
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y * z % Q
    return (x3, y3, z3)


def _add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 % Q * z2z2 % Q
    s2 = y2 * z1 % Q * z1z1 % Q
    if u1 == u2:
        return _double(p) if s1 == s2 else _INF
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % Q
    return (x3, y3, z3)


def _affine(p):
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, Q - 2, Q)
    zi2 = zi * zi % Q
    return (x * zi2 % Q, y * zi2 % Q * zi % Q)


def on_curve(p) -> bool:
    return p is None or (p[1] * p[1] - p[0] * p[0] * p[0] - B) % Q == 0


def msm(pairs) -> tuple | None:
    """sum of scalar * point over (scalar, affine point) pairs: one shared
    chain of doublings, each point added where its scalar has a bit."""
    pairs = [(s % R, _jac(p)) for s, p in pairs if p is not None and s % R]
    acc = _INF
    for bit in range(max((s.bit_length() for s, _ in pairs), default=0) - 1,
                     -1, -1):
        acc = _double(acc)
        for s, p in pairs:
            if (s >> bit) & 1:
                acc = _add(acc, p)
    return _affine(acc)


def mul(scalar: int, p=G1):
    return msm([(scalar, p)])


def neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


# -- encoding ---------------------------------------------------------------


def point_to_bytes(p) -> bytes:
    if p is None:
        return bytes(32)
    out = bytearray(p[0].to_bytes(32, "little"))
    out[31] |= (p[1] & 1) << 7
    return bytes(out)


def point_from_bytes(b: bytes):
    """The affine point of a compressed encoding; ValueError if it names
    none."""
    raw = bytearray(b)
    sign = raw[31] >> 7
    raw[31] &= 0x7F
    x = int.from_bytes(raw, "little")
    if x == 0:
        if sign:
            raise ValueError("invalid identity encoding")
        return None
    if x >= Q:
        raise ValueError("x coordinate out of range")
    rhs = (x * x * x + B) % Q
    y = pow(rhs, (Q + 1) // 4, Q)
    if y * y % Q != rhs:
        raise ValueError("x coordinate not on the curve")
    if y & 1 != sign:
        y = Q - y
    return (x, y)


def scalar_from_bytes(b: bytes) -> int:
    s = int.from_bytes(b, "little")
    if s >= R:
        raise ValueError("scalar out of range")
    return s
