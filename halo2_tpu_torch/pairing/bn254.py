"""BN254 (alt_bn128) pairing — host-side pure Python.

This is the stack's analogue of the reference's `pairing_bn256` crate
pairing engine, used only off-device:
  * `Decider::verify`-style final checks in the verifier
    (halo2_proofs/src/poly/multiopen.rs:33-55 computes
    e(L, s_g2) * e(R, -g2) == 1),
  * G2 arithmetic for SRS setup (`s_g2`,
    halo2_proofs/src/poly/commitment.rs:56-124).

The pairing is O(1) per proof verification — it never needs to be on the device.

Tower: Fq2 = Fq[u]/(u^2+1); Fq12 = Fq[w]/(w^12 - 18 w^6 + 82), with the
sextic twist by xi = 9 + u (the standard alt_bn128 construction used by
Ethereum's precompiles).  Structure follows the well-known py_ecc bn128
construction (public domain knowledge), reimplemented here.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle

from halo2_tpu_torch.fields.bn254 import FQ_MODULUS, FR_MODULUS

Q = FQ_MODULUS
R = FR_MODULUS

# BN parameter t: q = 36t^4 + 36t^3 + 24t^2 + 6t + 1
BN_T = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_T + 2  # 29793968203157093288


def _inv(a: int, m: int) -> int:
    return pow(a % m, m - 2, m)


# ---------------------------------------------------------------------------
# Polynomial-basis extension fields (coefficients are Python ints mod Q)
# ---------------------------------------------------------------------------

class _FQP:
    """Fq[x]/(modulus_coeffs) with dense coefficient vectors."""

    degree = 0
    modulus_coeffs = ()  # x^degree = -(sum modulus_coeffs[i] x^i)

    __slots__ = ("coeffs",)

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = tuple(c % Q for c in coeffs)

    @classmethod
    def one(cls):
        return cls((1,) + (0,) * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls((0,) * cls.degree)

    def __add__(self, other):
        if isinstance(other, int):
            return type(self)((self.coeffs[0] + other,) + self.coeffs[1:])
        return type(self)(tuple(a + b for a, b in zip(self.coeffs, other.coeffs)))

    def __sub__(self, other):
        if isinstance(other, int):
            return type(self)((self.coeffs[0] - other,) + self.coeffs[1:])
        return type(self)(tuple(a - b for a, b in zip(self.coeffs, other.coeffs)))

    def __rsub__(self, other):
        return -(self - other)

    def __neg__(self):
        return type(self)(tuple(-a for a in self.coeffs))

    def __mul__(self, other):
        if isinstance(other, int):
            return type(self)(tuple(a * other for a in self.coeffs))
        d = self.degree
        b = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, c in enumerate(other.coeffs):
                    b[i + j] += a * c
        # reduce by the modulus polynomial
        for i in range(2 * d - 2, d - 1, -1):
            top = b[i] % Q
            if top:
                b[i] = 0
                for j, m in enumerate(self.modulus_coeffs):
                    if m:
                        b[i - d + j] -= top * m
        return type(self)(tuple(b[:d]))

    __radd__ = __add__
    __rmul__ = __mul__

    def __pow__(self, e: int):
        result = type(self).one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Extended Euclid over Fq[x]."""
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = list(self.coeffs) + [0]
        high = list(self.modulus_coeffs) + [1]

        def deg(p):
            dd = len(p) - 1
            while dd and p[dd] % Q == 0:
                dd -= 1
            return dd

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            o = [0] * len(a)
            for i in range(dega - degb, -1, -1):
                o[i] += temp[degb + i] * _inv(b[degb], Q)
                for c in range(degb + 1):
                    temp[c + i] -= o[c]
            return [x % Q for x in o[: deg(o) + 1]]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (d + 1 - len(r))
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv0 = _inv(low[0], Q)
        return type(self)(tuple(c * inv0 for c in lm[:d]))

    def __truediv__(self, other):
        if isinstance(other, int):
            return self * _inv(other, Q)
        return self * other.inv()

    def __eq__(self, other):
        if isinstance(other, int):
            return self.coeffs[0] == other % Q and all(c == 0 for c in self.coeffs[1:])
        return self.coeffs == other.coeffs

    def __hash__(self):
        return hash(self.coeffs)

    def __repr__(self):
        return f"{type(self).__name__}{self.coeffs}"


class FQ2(_FQP):
    degree = 2
    modulus_coeffs = (1, 0)  # u^2 = -1


class FQ12(_FQP):
    degree = 12
    modulus_coeffs = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # w^12 = 18w^6 - 82


# ---------------------------------------------------------------------------
# G2 (over FQ2) affine arithmetic; points are (x, y) FQ2 pairs or None
# ---------------------------------------------------------------------------

# Standard alt_bn128 G2 generator
G2_GEN = (
    FQ2((
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    )),
    FQ2((
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    )),
)

# twist curve: y^2 = x^3 + b / xi, xi = 9 + u
B2 = FQ2((3, 0)) / FQ2((9, 1))


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return y * y - x * x * x == B2


def g2_neg(p):
    if p is None:
        return None
    x, y = p
    return (x, -y)


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return g2_double(p)
        return None
    lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_double(p):
    if p is None:
        return None
    x, y = p
    lam = (x * x * 3) / (y * 2)
    x3 = lam * lam - x - x
    y3 = lam * (x - x3) - y
    return (x3, y3)


def g2_mul(p, k: int):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_double(p)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# Twist embedding G2 -> E(FQ12) and the pairing
# ---------------------------------------------------------------------------

_W = FQ12((0, 1) + (0,) * 10)  # w


def twist(p):
    """Map a G2 point on the twist into E(Fq12)."""
    if p is None:
        return None
    x, y = p
    # unpack FQ2 as a + b*u, re-express over the 1, w^6 basis (u = w^6 - 9)
    xc = (x.coeffs[0] - 9 * x.coeffs[1], x.coeffs[1])
    yc = (y.coeffs[0] - 9 * y.coeffs[1], y.coeffs[1])
    nx = FQ12((xc[0],) + (0,) * 5 + (xc[1],) + (0,) * 5)
    ny = FQ12((yc[0],) + (0,) * 5 + (yc[1],) + (0,) * 5)
    return (nx * _W * _W, ny * _W * _W * _W)


def cast_g1_to_fq12(p):
    if p is None:
        return None
    x, y = p
    return (FQ12((x,) + (0,) * 11), FQ12((y,) + (0,) * 11))


def _fq12_double(p):
    x, y = p
    lam = (x * x * 3) / (y * 2)
    x3 = lam * lam - x - x
    y3 = lam * (x - x3) - y
    return (x3, y3)


def _fq12_add(p, q):
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and y1 == y2:
        return _fq12_double(p)
    if x1 == x2:
        return None
    lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 (E(Fq12) points) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    elif y1 == y2:
        m = (x1 * x1 * 3) / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


def miller_loop(q12, p12):
    """Miller loop for the optimal ate pairing (alt_bn128 flavor)."""
    if q12 is None or p12 is None:
        return FQ12.one()
    rpt = q12
    f = FQ12.one()
    for b in bin(ATE_LOOP_COUNT)[2:][1:]:  # bits MSB-first, top bit implicit
        f = f * f * linefunc(rpt, rpt, p12)
        rpt = _fq12_double(rpt)
        if b == "1":
            f = f * linefunc(rpt, q12, p12)
            rpt = _fq12_add(rpt, q12)
    q1 = (q12[0] ** Q, q12[1] ** Q)
    nq2 = (q1[0] ** Q, -(q1[1] ** Q))
    f = f * linefunc(rpt, q1, p12)
    rpt = _fq12_add(rpt, q1)
    f = f * linefunc(rpt, nq2, p12)
    return f ** ((Q ** 12 - 1) // R)


def pairing(q_g2, p_g1):
    """e(P, Q) with P in G1 (int pair), Q in G2 (FQ2 pair). Returns FQ12."""
    if p_g1 is None or q_g2 is None:
        return FQ12.one()
    assert g2_is_on_curve(q_g2), "Q not on G2 twist"
    return final_exponentiation(prepare_g2(q_g2).miller_loop(p_g1))


# ---------------------------------------------------------------------------
# Fast verifier path: prepared lines, Frobenius maps, one final exponentiation
#
# The generic construction above (miller_loop + a 4566-bit generic pow) is
# the golden model; verification latency comes from this section:
#   * G2Prepared precomputes every Miller-loop line's (slope, intercept)
#     for a FIXED G2 point — the verifier's two points (s_g2, -g2) never
#     change per SRS, so all G2-side Fq12 inversions/pows leave the
#     per-proof path entirely;
#   * the Frobenius endomorphism is a 24-mul linear map (precomputed
#     gamma = v^{(q-1)/6} coefficients) instead of a 254-bit pow;
#   * one SHARED final exponentiation over the product of Miller values,
#     with the standard BN easy-part/hard-part decomposition (3 short
#     exponentiations by t + Frobenius maps) instead of a generic
#     ((q^12-1)/r)-pow per pairing.
# ---------------------------------------------------------------------------

def _compute_gamma_pows():
    """gamma^i for i in 0..11, gamma = v^{(q-1)/6} in Fq[v] ~ Fq2
    (v = w^6 = 9 + u): the per-basis-element Frobenius factors
    (w^i)^q = w^i * gamma^i."""
    g = FQ2((9, 1)) ** ((Q - 1) // 6)       # in u-basis: g0 + g1*u
    out = []
    acc = FQ2((1, 0))
    for _ in range(12):
        a, b = acc.coeffs                   # a + b*u = (a - 9b) + b*v
        out.append(((a - 9 * b) % Q, b))
        acc = acc * g
    return out


_GAMMA_POWS = _compute_gamma_pows()


def frobenius(x: FQ12) -> FQ12:
    """x^q as a linear map: coefficients are in Fq (fixed by Frobenius),
    so x^q = sum a_i (w^i)^q = sum a_i w^i gamma^i with gamma^i in Fq[v],
    v = w^6 and w^12 = 18 w^6 - 82 folding the overflow terms."""
    out = [0] * 12
    for i in range(12):
        a = x.coeffs[i]
        if not a:
            continue
        g0, g1 = _GAMMA_POWS[i]
        out[i] += a * g0
        if g1:
            j = i + 6
            if j < 12:
                out[j] += a * g1
            else:
                out[j - 12] -= 82 * a * g1
                out[j - 6] += 18 * a * g1
    return FQ12(tuple(out))


def frobenius_k(x: FQ12, k: int) -> FQ12:
    for _ in range(k):
        x = frobenius(x)
    return x


def conjugate(x: FQ12) -> FQ12:
    """x^{q^6} — the cyclotomic inverse after the easy part."""
    return frobenius_k(x, 6)


def _pow_t(x: FQ12) -> FQ12:
    """x^BN_T (63-bit square-and-multiply)."""
    return x ** BN_T


def final_exponentiation(f: FQ12) -> FQ12:
    """f^((q^12-1)/r) via the standard BN decomposition
    (easy part (q^6-1)(q^2+1), then the Scott et al. hard-part addition
    chain with three exponentiations by t); verified against the generic
    pow in tests/test_pairing.py."""
    # easy part
    f = conjugate(f) * f.inv()              # f^(q^6 - 1)
    f = frobenius_k(f, 2) * f               # ^(q^2 + 1)
    # hard part (f is now in the cyclotomic subgroup: inverse = conjugate)
    fu = _pow_t(f)
    fu2 = _pow_t(fu)
    fu3 = _pow_t(fu2)
    fp = frobenius(f)
    fp2 = frobenius(fp)
    fp3 = frobenius(fp2)
    y0 = fp * fp2 * fp3
    y1 = conjugate(f)
    y2 = frobenius_k(fu2, 2)
    y3 = conjugate(frobenius(fu))
    y4 = conjugate(fu * frobenius(fu2))
    y5 = conjugate(fu2)
    y6 = conjugate(fu3 * frobenius(fu3))
    t0 = y6 * y6 * y4 * y5
    t1 = y3 * y5 * t0
    t0 = t0 * y2
    t1 = t1 * t1 * t0
    t1 = t1 * t1
    t0 = t1 * y1
    t1 = t1 * y0
    t0 = t0 * t0
    return t0 * t1


def _line_coeffs(p1, p2):
    """Line through p1, p2 (E(Fq12) points) as evaluation coefficients:
    returns (m, c, has_y) with line(t) = m*x_t + c - y_t when has_y, else
    x_t + c (vertical) — matching linefunc's three branches."""
    x1, y1 = p1
    x2, y2 = p2
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
    elif y1 == y2:
        m = (x1 * x1 * 3) / (y1 * 2)
    else:
        return (None, -x1, False)
    return (m, y1 - m * x1, True)


class G2Prepared:
    """Miller-loop line coefficients for a fixed G2 point: every slope
    (and its Fq12 inversion) is paid once per SRS, not per proof."""

    __slots__ = ("steps",)

    def __init__(self, q_g2):
        assert g2_is_on_curve(q_g2), "Q not on G2 twist"
        q12 = twist(q_g2)
        steps = []                     # ("d"|"a", m, c, has_y)
        rpt = q12
        for b in bin(ATE_LOOP_COUNT)[2:][1:]:
            steps.append(("d",) + _line_coeffs(rpt, rpt))
            rpt = _fq12_double(rpt)
            if b == "1":
                steps.append(("a",) + _line_coeffs(rpt, q12))
                rpt = _fq12_add(rpt, q12)
        q1 = (frobenius(q12[0]), frobenius(q12[1]))
        nq2 = (frobenius(q1[0]), -frobenius(q1[1]))
        steps.append(("a",) + _line_coeffs(rpt, q1))
        rpt = _fq12_add(rpt, q1)
        steps.append(("a",) + _line_coeffs(rpt, nq2))
        self.steps = steps

    def miller_loop(self, p_g1) -> FQ12:
        """Miller value (NO final exponentiation) at a G1 point: per step
        one scalar-by-Fq12 line evaluation + one or two Fq12 mults."""
        if p_g1 is None:
            return FQ12.one()
        xt, yt = p_g1[0] % Q, p_g1[1] % Q
        f = FQ12.one()
        for tag, m, c, has_y in self.steps:
            if has_y:
                cf = list((m * xt).coeffs)
                cf[0] = (cf[0] - yt) % Q
                line = FQ12(tuple(x + y for x, y in zip(cf, c.coeffs)))
            else:
                cf = list(c.coeffs)
                cf[0] = (cf[0] + xt) % Q
                line = FQ12(tuple(cf))
            if tag == "d":
                f = f * f
            f = f * line
        return f


_PREPARED_CACHE: dict = {}

# Disk cache for prepared lines: the ~100 Miller-loop steps each pay an
# Fq12 inversion in _line_coeffs (some 0.5 s a G2 point), and the
# verifier's G2 points (g2, s_g2) are fixed per SRS, so the first verify in
# a fresh process can load the lines instead of computing them.  Keyed by a
# hash of the G2 point's coordinates.  HALO2_TPU_G2_CACHE=<dir> relocates
# it, =0 or =off disables it.  The key hash and the file's contents are
# the JAX package's (halo2_tpu/pairing/bn254.py), so either package loads
# the other's files.
_G2_CACHE_DIR = os.environ.get(
    "HALO2_TPU_G2_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "halo2_tpu_torch",
                 "g2_lines"))


def _disk_path(key):
    if _G2_CACHE_DIR in ("0", "off", ""):
        return None
    h = hashlib.blake2b(repr(key).encode(), digest_size=16).hexdigest()
    return os.path.join(_G2_CACHE_DIR, h + ".lines")


def _steps_to_wire(steps):
    return [(tag, None if m is None else m.coeffs, c.coeffs, has_y)
            for tag, m, c, has_y in steps]


def _fq12_from_wire(coeffs) -> FQ12:
    if (not isinstance(coeffs, tuple) or len(coeffs) != 12
            or not all(type(x) is int for x in coeffs)):
        raise ValueError("a line coefficient is not 12 integers")
    return FQ12(coeffs)


def _steps_from_wire(wire):
    if not isinstance(wire, list):
        raise ValueError("the lines are not a list of steps")
    steps = []
    for step in wire:
        if (not isinstance(step, tuple) or len(step) != 4
                or step[0] not in ("a", "d") or type(step[3]) is not bool):
            raise ValueError("a step is not (tag, m, c, has_y)")
        tag, m, c, has_y = step
        steps.append((tag, None if m is None else _fq12_from_wire(m),
                      _fq12_from_wire(c), has_y))
    return steps


class _LinesUnpickler(pickle.Unpickler):
    """Loads plain containers, strings and integers only: a lines file
    names no class."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"a lines file names {module}.{name}")


def _read_lines(path):
    with open(path, "rb") as fh:
        return _steps_from_wire(_LinesUnpickler(io.BytesIO(fh.read()))
                                .load())


def _write_lines(path, steps):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        pickle.dump(_steps_to_wire(steps), fh,
                    protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def prepare_g2(q_g2) -> G2Prepared:
    """Cached G2Prepared — the verifier's G2 points are fixed per SRS.
    Memory cache first, then the on-disk line cache, then compute and
    store (a file that cannot be read is computed and written again)."""
    key = (q_g2[0].coeffs, q_g2[1].coeffs)
    prep = _PREPARED_CACHE.get(key)
    if prep is not None:
        return prep
    path = _disk_path(key)
    if path is not None and os.path.exists(path):
        try:
            prep = G2Prepared.__new__(G2Prepared)
            prep.steps = _read_lines(path)
        except (OSError, EOFError, ValueError, pickle.UnpicklingError):
            prep = None
    if prep is None:
        prep = G2Prepared(q_g2)
        if path is not None:
            try:
                _write_lines(path, prep.steps)
            except OSError:
                pass                      # a cache that cannot be written
    if len(_PREPARED_CACHE) < 16:
        _PREPARED_CACHE[key] = prep
    return prep


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — the multi-Miller-loop Decider check
    (halo2_proofs/src/poly/multiopen.rs:33-55): one shared
    final exponentiation over the product of Miller values."""
    acc = FQ12.one()
    for p_g1, q_g2 in pairs:
        if p_g1 is None or q_g2 is None:
            continue
        acc = acc * prepare_g2(q_g2).miller_loop(p_g1)
    if acc == FQ12.one():
        return True
    return final_exponentiation(acc) == FQ12.one()
