"""The SRS setup's pieces on the CPU: the fixed-base comb of the generator
(`g1.fixed_base_mul`), setup's scalars made by field operations
(`commitment.setup_scalars`), and the pow kernel's schedule
(`cuda_ops.pow_schedule`).

On the card the comb and pow are one launch each; here the tests hold:

  * the comb's table against the JAX package's host table
    (`halo2_tpu.curves.host.fixed_base_tables`, pure Python), point for
    point;
  * `plain_fixed_base_mul` against the JAX package's host
    `fixed_base_mul` (what its setup runs on its CPU backend) and the
    port's plain ladder, in affine, on edge and random scalars;
  * setup's scalars against the reference's host lists
    (halo2_tpu/poly/commitment.py:130-147, its own `_batch_inv_host`), and
    the setup's bases against the host points of those scalars;
  * a host-integer model of the pow kernel (odd powers, then the
    schedule's squarings and products, as csrc/field_kernels.cu reads its
    step words) against Python's pow, and `Field.pow_static`;
  * that CPU tensors launch nothing and that the comb's wrapper refuses
    them.

No XLA compile: the JAX side is pure-Python host code.  Tolerance: none,
integers and limb words are compared for equality.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from halo2_tpu.curves import host as jhost
from halo2_tpu.fields.bn254 import FR_ROOT_OF_UNITY, FR_S
from halo2_tpu.poly.commitment import _batch_inv_host as j_batch_inv

from halo2_tpu_torch.curves import cuda_point, g1
from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields import limbs as tl
from halo2_tpu_torch.fields.bn254 import FQ_MODULUS, FR_MODULUS, fq, fr
from halo2_tpu_torch.poly.commitment import Params, setup_scalars
from halo2_tpu_torch.utils import profiling

torch.set_num_threads(1)

Q, R = FQ_MODULUS, FR_MODULUS


def _edge_scalars(seed: int, n: int = 64) -> list:
    """0, 1, 255, 256, r - 1, every byte 0xFF, only the top window set
    (its least and its largest digit), every window 1, then random
    scalars below r and below 2^256 from a numpy seed."""
    rng = np.random.default_rng(seed)
    ks = [0, 1, 255, 256, R - 1, (1 << 256) - 1, 1 << 248, 0xFF << 248,
          sum(1 << (8 * w) for w in range(32))]
    while len(ks) < n:
        k = int.from_bytes(rng.bytes(32), "little")
        ks.append(k if len(ks) % 2 else k % R)
    return ks


def _limbs(ks):
    return tl.to_tensor(tl.ints_to_limbs_np(ks), "cpu")


def test_table_equals_the_reference_host_table():
    """Entry (w, d) is d * 2^(8w) * G: x Z^2 = X and y Z^3 = Y against the
    reference's Jacobian table; digit 0's entries are (0, 0)."""
    ref = jhost.fixed_base_tables(jhost.G1_GEN)
    xy = g1.fixed_base_table("cpu").xy
    assert tuple(xy.shape) == (2, 16, g1.FB_WINDOWS * g1.FB_DIGITS)
    F = fq("cpu")
    xs, ys = F.decode(xy[0]), F.decode(xy[1])
    assert len(ref) == g1.FB_WINDOWS
    for w, row in enumerate(ref):
        for d, (X, Y, Z) in enumerate(row):
            x, y = xs[w * 256 + d], ys[w * 256 + d]
            if d == 0:
                assert (x, y) == (0, 0) and Z == 0
                continue
            z2 = Z * Z % Q
            assert x * z2 % Q == X and y * z2 * Z % Q == Y


def test_plain_comb_equals_the_reference_and_the_ladder():
    ks = _edge_scalars(5)
    s = _limbs(ks)
    got = g1.decode_points(g1.to_affine(g1.fixed_base_mul(s)))
    tab = jhost.fixed_base_tables(jhost.G1_GEN)
    assert got == [jhost.jac_to_affine(jhost.fixed_base_mul(tab, k))
                   for k in ks]
    gen = g1.generator("cpu")
    base = tuple(c[:, None].expand(16, len(ks)).contiguous() for c in gen)
    ladder = g1.to_affine(g1.plain_scalar_mul(base, s))
    comb = g1.to_affine(g1.plain_fixed_base_mul(
        g1.fixed_base_table("cpu").xy, s))
    assert all(torch.equal(a, b) for a, b in zip(comb, ladder))


def test_plain_comb_on_batch_shapes_and_views():
    """Two batch dims and a strided view give the flat result's limbs."""
    s = _limbs(_edge_scalars(6, 24))
    flat = g1.fixed_base_mul(s)
    two = g1.fixed_base_mul(s.reshape(16, 4, 6))
    assert all(torch.equal(a.reshape(16, 24), b) for a, b in zip(two, flat))
    every_other = g1.fixed_base_mul(s[:, ::2])
    assert all(torch.equal(a, b[:, ::2]) for a, b in zip(every_other, flat))
    assert bool(g1.is_identity(flat)[0])              # 0 * G


def _reference_lists(k: int, s: int):
    """The reference's host lists (halo2_tpu/poly/commitment.py:130-147)."""
    n = 1 << k
    powers, acc = [], 1
    for _ in range(n):
        powers.append(acc)
        acc = acc * s % R
    omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - k), R)
    n_inv = pow(n, R - 2, R)
    multiplier = (pow(s, n, R) - 1) * n_inv % R
    root_pows, rp = [], 1
    for _ in range(n):
        root_pows.append(rp)
        rp = rp * omega % R
    denoms = [(s - rp) % R for rp in root_pows]
    denom_invs = j_batch_inv(denoms, R)
    lag = [multiplier * rp % R * di % R
           for rp, di in zip(root_pows, denom_invs)]
    return powers, lag


@pytest.mark.parametrize("k,seed", [(1, 3), (4, 7), (6, 11)])
def test_setup_scalars_equal_the_reference_host_lists(k, seed):
    s = random.Random(seed).randrange(1, R)
    powers, lag = setup_scalars(k, s, "cpu")
    want_p, want_l = _reference_lists(k, s)
    assert tl.limbs_to_ints(tl.to_numpy(powers)) == want_p
    assert tl.limbs_to_ints(tl.to_numpy(lag)) == want_l


def test_setup_scalars_at_s_a_root_of_unity():
    """s = w^3 makes one denominator 0: the reference's host inversion
    maps it to 0, and so does the port's batch inversion."""
    k = 3
    s = pow(pow(FR_ROOT_OF_UNITY, 1 << (FR_S - k), R), 3, R)
    powers, lag = setup_scalars(k, s, "cpu")
    want_p, want_l = _reference_lists(k, s)
    assert tl.limbs_to_ints(tl.to_numpy(powers)) == want_p
    assert tl.limbs_to_ints(tl.to_numpy(lag)) == want_l
    assert want_l[3] == 0


def test_setup_bases_and_phases():
    """The bases are the host multiples of G by the reference's lists, and
    the phases are marked."""
    k, seed = 3, 9
    phases = profiling.PhaseTimes("cpu")
    params = Params.unsafe_setup(k, seed=seed, device="cpu", phases=phases)
    assert list(phases.seconds) == ["scalars", "g", "g_lagrange", "s_g2"]
    powers, lag = _reference_lists(k, random.Random(seed).randrange(1, R))
    assert g1.decode_points(params.g) == [jhost.mul(jhost.G1_GEN, e)
                                          for e in powers]
    assert g1.decode_points(params.g_lagrange) == [
        jhost.mul(jhost.G1_GEN, e) for e in lag]


def _run_schedule(x: int, e: int, p: int):
    """The pow kernel on integers: its odd powers, then its step words.
    Returns x^e and the squarings and multiplies it made."""
    plan = cuda_ops.pow_schedule(e)
    if plan["first"] < 0:
        return 1, 0, 0
    x2 = x * x % p
    sqr, mul = int(plan["entries"] > 1), 0
    odd = [x]
    for _ in range(1, plan["entries"]):
        odd.append(odd[-1] * x2 % p)
        mul += 1
    r = odd[plan["first"]]
    for word in plan["words"]:
        for _ in range(word >> 4):
            r = r * r % p
            sqr += 1
        if word & 15:
            r = r * odd[(word & 15) - 1] % p
            mul += 1
    return r, sqr, mul


POW_EXPONENTS = [0, 1, 2, 3, 5, (Q + 1) // 4, Q - 2, R - 2, (1 << 255) + 1,
                 (1 << 256) - 1]


@pytest.mark.parametrize("p", [Q, R])
def test_pow_schedule_model_equals_python_pow(p):
    rng = np.random.default_rng(12)
    es = POW_EXPONENTS + [int.from_bytes(rng.bytes(32), "little")
                          for _ in range(40)] + [int(v) for v in
                                                 rng.integers(0, 1 << 20, 40)]
    xs = [0, 1, p - 1] + [int.from_bytes(rng.bytes(40), "little") % p
                          for _ in range(5)]
    for e in es:
        for x in xs:
            assert _run_schedule(x, e, p)[0] == pow(x, e, p)


def _square_multiply(e: int) -> int:
    return 0 if e == 0 else e.bit_length() - 1 + bin(e).count("1") - 1


def test_pow_schedule_counts():
    """The square root's exponent: windows of 4 bits, 305 products against
    359 by square and multiply (251 squarings, 108 products), of them 251
    squarings and 54 multiplies; the products counted are the model's: the
    odd powers' and the steps'."""
    e = (Q + 1) // 4
    plan = cuda_ops.pow_schedule(e)
    assert (plan["window"], plan["products"]) == (4, 305)
    assert (plan["squarings"], plan["multiplies"]) == (251, 54)
    assert _square_multiply(e) == 359
    steps = sum((w >> 4) + bool(w & 15) for w in plan["words"])
    assert plan["products"] == steps + plan["entries"]
    for e in POW_EXPONENTS:
        plan = cuda_ops.pow_schedule(e)
        assert plan["products"] <= _square_multiply(e)
        assert _run_schedule(3, e, Q)[1:] == (plan["squarings"],
                                              plan["multiplies"])
        assert plan["squarings"] + plan["multiplies"] == plan["products"]


# -- the Montgomery squaring of csrc/field.cuh, its PTX run on integers ------

FIELD_CUH = (Path(__file__).resolve().parents[1] / "halo2_tpu_torch"
             / "csrc" / "field.cuh")
M32 = (1 << 32) - 1


def _asm_lines(fn: str) -> list:
    """The PTX instructions of the asm block of device function `fn`."""
    src = FIELD_CUH.read_text()
    body = src[src.index(f" {fn}("):]
    body = body[body.index("asm("):body.index("\n      :")]
    return re.findall(r'"([^"]*?);\\n\\t"', body)


def _run_ptx(lines: list, regs: list) -> None:
    """Run mad/madc (.lo/.hi), add/addc (.cc) on 32-bit registers %i =
    regs[i] with PTX's carry flag, in place."""
    cc = 0
    for line in lines:
        op, args = line.split(None, 1)
        d, *src = [a.strip() for a in args.split(",")]
        val = [regs[int(a[1:])] if a.startswith("%") else int(a)
               for a in src]
        parts = op.split(".")
        if parts[0] in ("mad", "madc"):
            prod = val[0] * val[1]
            v = (prod & M32 if parts[1] == "lo" else prod >> 32) + val[2]
        else:
            assert parts[0] in ("add", "addc"), op
            v = val[0] + val[1]
        if parts[0].endswith("c"):
            v += cc
        regs[int(d[1:])] = v & M32
        if "cc" in parts:
            cc = v >> 32


def _words(x: int, n: int = 8) -> list:
    return [(x >> (32 * k)) & M32 for k in range(n)]


def _from_words(w) -> int:
    return sum(v << (32 * k) for k, v in enumerate(w))


def _mont_sqr_model(a: int, p: int) -> int:
    """field.cuh's mont_sqr step by step: sqr_wide's PTX, then eight rows of
    mad_row's PTX over the low half, the high half added, one conditional
    subtraction."""
    regs = [0] * 16 + _words(a)
    _run_ptx(_asm_lines("sqr_wide"), regs)
    T = regs[:16]
    assert _from_words(T) == a * a
    inv = -pow(p, -1, 1 << 32) & M32
    t = T[:8] + [0, 0]
    for _ in range(8):
        regs = t + _words(p) + [t[0] * inv & M32]
        _run_ptx(_asm_lines("mad_row"), regs)
        assert regs[0] == 0 and regs[9] == 0       # below 2^288
        t = regs[1:10] + [0]
    assert t[8] == 0
    r = _from_words(t[:8]) + _from_words(T[8:])
    assert r < 2 * p
    return r - p if r >= p else r


@pytest.mark.parametrize("p", [Q, R])
def test_mont_sqr_ptx_model(p):
    """The squaring's carry chains give a^2 exactly (any 256-bit a), and
    mont_sqr gives a^2 / R mod p, what mont_mul(a, a) gives, for a < p."""
    rng = np.random.default_rng(21)
    mont_r = (1 << 256) % p
    for a in [(1 << 256) - 1, 1 << 255, M32] + [
            int.from_bytes(rng.bytes(32), "little") for _ in range(50)]:
        regs = [0] * 16 + _words(a)
        _run_ptx(_asm_lines("sqr_wide"), regs)
        assert _from_words(regs[:16]) == a * a
    r_inv = pow(1 << 256, -1, p)
    for a in [0, 1, 2, p - 1, p - 2, mont_r, p >> 1, (p + 1) >> 1] + [
            int.from_bytes(rng.bytes(40), "little") % p for _ in range(200)]:
        assert _mont_sqr_model(a, p) == a * a * r_inv % p


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_pow_static_equals_plain_and_python(name):
    F = fr("cpu") if name == "Fr" else fq("cpu")
    rng = np.random.default_rng(13)
    xs = [0, 1, F.p - 1] + [int.from_bytes(rng.bytes(40), "little") % F.p
                            for _ in range(5)]
    a = F.encode(xs)
    for e in (0, 1, 2, 3, 5, (F.p + 1) // 4):
        got = F.pow_static(a, e)
        assert torch.equal(got, F.plain_pow_static(a, e))
        assert F.decode(got) == [pow(x, e, F.p) for x in xs]


def test_cpu_comb_launches_nothing_and_the_wrapper_refuses_cpu():
    for key in cuda_point.launch_counts:
        cuda_point.launch_counts[key] = 0
    s = _limbs([3, 5])
    g1.fixed_base_mul(s)
    assert cuda_point.launch_counts["fixed_base"] == 0
    assert set(cuda_point.launch_counts.values()) == {0}
    with pytest.raises(ValueError):
        cuda_point.fixed_base_mul(torch.zeros(
            (cuda_point.FIXED_BASE_ROWS, 16), dtype=torch.int32), s)
