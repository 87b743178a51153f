"""halo2_tpu_torch polynomial layer (poly/arith.py, poly/domain.py,
poly/commitment.py) against Python integers and the host curve, on the CPU.

These modules hold no kernel of their own: they compose the field, NTT and
MSM layers, whose modules are held against the JAX package in their own
files; the slice as a whole is in tests/test_torch_prover.py.  Tolerance:
none — integers are compared for equality.
"""

import io
import itertools
import random

import pytest
import torch

from halo2_tpu_torch.curves import g1, host
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.poly import arith
from halo2_tpu_torch.poly.commitment import (Params, g2_from_bytes,
                                             g2_to_bytes)
from halo2_tpu_torch.poly.domain import EvaluationDomain, Polynomial

torch.set_num_threads(1)

K = 3
N = 1 << K


def _rand(seed, n):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def _eval(coeffs, z):
    return sum(c * pow(z, i, P) for i, c in enumerate(coeffs)) % P


@pytest.fixture(scope="module")
def params():
    return Params.unsafe_setup(K, seed=11, device="cpu")


@pytest.fixture(scope="module")
def domain():
    return EvaluationDomain(4, K, "cpu")


@pytest.mark.parametrize("n", [1, 5, 4096, 9000])
def test_field_sum_and_prefix_sum(n):
    F = fr("cpu")
    vals = _rand(n, n)
    a = F.encode(vals)
    assert F.decode_scalar(arith.field_sum(a)) == sum(vals) % P
    assert F.decode(arith.prefix_sum(a)) == \
        [x % P for x in itertools.accumulate(vals)]


def test_field_sum_over_column_stack():
    F = fr("cpu")
    cols = [_rand(c, 37) for c in range(3)]
    stack = torch.stack([F.encode(c) for c in cols], dim=1)
    assert F.decode(arith.field_sum(stack)) == [sum(c) % P for c in cols]


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_point_powers(n):
    F = fr("cpu")
    z = _rand(99, 1)[0]
    assert F.decode(arith.PointPowers.get(z, n, "cpu")) == \
        [pow(z, i, P) for i in range(n)]


def test_eval_poly_and_batch():
    F = fr("cpu")
    polys = [_rand(s, 16) for s in (1, 2, 3)]
    z = _rand(4, 1)[0]
    assert arith.eval_poly(F.encode(polys[0]), z) == _eval(polys[0], z)
    assert arith.eval_poly_batch([F.encode(p) for p in polys], z) == \
        [_eval(p, z) for p in polys]
    assert arith.eval_poly_batch([], z) == []


@pytest.mark.parametrize("n", [2, 8, 33])
def test_kate_division(n):
    F = fr("cpu")
    coeffs, b = _rand(n, n), _rand(n + 1, 1)[0]
    q = F.decode(arith.kate_division(F.encode(coeffs), b))
    # (X - b) q(X) == p(X) - p(b)
    prod = [0] * (n + 1)
    for i, qi in enumerate(q):
        prod[i + 1] = (prod[i + 1] + qi) % P
        prod[i] = (prod[i] - b * qi) % P
    want = list(coeffs)
    want[0] = (want[0] - _eval(coeffs, b)) % P
    assert prod[:n] == want and prod[n] == 0
    with pytest.raises(ValueError):
        arith.kate_division(F.encode(coeffs), 0)


def test_domain_transforms_round_trip(domain):
    F = domain.F
    coeffs = _rand(5, N)
    c = domain.coeff_from_ints(coeffs)
    lag = domain.coeff_to_lagrange(c)
    assert F.decode(lag.values) == [_eval(coeffs, pow(domain.omega, i, P))
                                    for i in range(N)]
    assert torch.equal(domain.lagrange_to_coeff(lag).values, c.values)
    assert torch.equal(
        domain.lagrange_from_ints(F.decode(lag.values)).values, lag.values)


def test_coset_extension_and_back(domain):
    F = domain.F
    coeffs = _rand(6, N)
    ext = domain.coeff_to_extended(domain.coeff_from_ints(coeffs))
    assert len(ext) == domain.extended_n
    assert F.decode(ext.values) == [
        _eval(coeffs, domain.g_coset * pow(domain.extended_omega, i, P) % P)
        for i in range(domain.extended_n)]
    back = F.decode(domain.extended_to_coeff(ext))
    assert back[:N] == coeffs and set(back[N:]) == {0}


def test_divide_by_vanishing_poly(domain):
    F = domain.F
    vals = _rand(7, domain.extended_n)
    out = domain.divide_by_vanishing_poly(
        Polynomial(F.encode(vals), "extended"))
    for i, (v, o) in enumerate(zip(vals, F.decode(out.values))):
        x = domain.g_coset * pow(domain.extended_omega, i, P) % P
        assert o * (pow(x, N, P) - 1) % P == v


def test_rotations_and_lagrange_basis(domain):
    F = domain.F
    vals = _rand(8, domain.extended_n)
    scale = domain.extended_n // N
    rolled = F.decode(domain.rotate_extended(F.encode(vals), 1))
    assert rolled == vals[scale:] + vals[:scale]
    x = _rand(9, 1)[0]
    assert domain.rotate_omega(x, -2) == x * pow(domain.omega_inv, 2, P) % P
    xn = pow(x, N, P)
    for rot, got in zip((-1, 0, 2), domain.l_i_range(x, xn, (-1, 0, 2))):
        onehot = [0] * N
        onehot[rot % N] = 1
        coeffs = F.decode(domain.lagrange_to_coeff(
            domain.lagrange_from_ints(onehot)).values)
        assert got == _eval(coeffs, x)


def test_polynomial_arithmetic_and_basis_checks(domain):
    F = domain.F
    a, b = _rand(10, N), _rand(11, N)
    pa, pb = domain.coeff_from_ints(a), domain.coeff_from_ints(b)
    assert F.decode((pa + pb).values) == [(x + y) % P for x, y in zip(a, b)]
    assert F.decode((pa - pb).values) == [(x - y) % P for x, y in zip(a, b)]
    assert F.decode(pa.scale(F.encode_scalar(3)).values) == \
        [3 * x % P for x in a]
    assert F.decode(domain.constant_lagrange(5).values) == [5] * N
    assert len(domain.empty_extended()) == domain.extended_n
    with pytest.raises(ValueError):
        pa + domain.lagrange_from_ints(a)
    with pytest.raises(ValueError):
        domain.coeff_to_lagrange(domain.lagrange_from_ints(a))


def test_setup_bases_are_the_powers_of_s(params):
    rng = random.Random(11)
    s = rng.randrange(1, P)
    g = g1.decode_points(params.g)
    assert g == [host.mul(host.G1_GEN, pow(s, i, P)) for i in range(N)]
    # sum of the Lagrange bases = commitment to the constant 1 = G
    total = None
    for pt in g1.decode_points(params.g_lagrange):
        total = host.add(total, pt)
    assert total == host.G1_GEN


@pytest.mark.parametrize("base", ["coeff", "lagrange"])
def test_commit_vs_host_msm(params, base):
    F = fr("cpu")
    cols = [_rand(20, N), [1] + [0] * (N - 1), _rand(21, N)]
    bases = g1.decode_points(params.g if base == "coeff"
                             else params.g_lagrange)
    got = params.commit_many_affine([F.encode(c) for c in cols], base=base)
    assert got == [host.msm(bases, c) for c in cols]
    single = (params.commit if base == "coeff"
              else params.commit_lagrange)(F.encode(cols[0]))
    assert g1.decode_points(g1.to_affine(
        tuple(c[:, None] for c in single))) == [got[0]]


def test_commit_bounded_bits_and_verifier_params(params):
    F = fr("cpu")
    small = [random.Random(5).randrange(1 << 16) for _ in range(N)]
    got = params.commit_many_affine([F.encode(small)], [16], base="lagrange")
    bases = g1.decode_points(params.g_lagrange)
    assert got == [host.msm(bases, small)]
    pv = params.verifier(2)
    assert pv.commit_lagrange(small[:2]) == host.msm(bases[:2], small[:2])
    assert params.commit_many_affine([]) == []
    with pytest.raises(ValueError):
        params.commit_many([F.encode(small)], base="monomial")


def test_params_write_read_and_g2_codec(params):
    buf = io.BytesIO()
    params.write(buf)
    again = Params.read(io.BytesIO(buf.getvalue()), device="cpu")
    assert again.k == K and torch.equal(again.g_lagrange, params.g_lagrange)
    assert again.s_g2 == params.s_g2
    assert g2_from_bytes(g2_to_bytes(params.s_g2)) == params.s_g2
    assert g2_from_bytes(bytes(64)) is None
