"""The chain entry points of kernels K1 and K4 (pow / inv, the prefix-product
scan, the Horner combine, the scalar ladder), on the CPU.

On the card each of these is one launch (three for the scan); here the
tests hold what can run without one:

  * the Python that plans the launches: the exponent's words, the scan's
    chunk plan for any n, the reverse scan's origin and stride, a model of
    the scan's three passes on that plan, the Horner combine's lane and
    window shape, the operand strides `binop` passes without a copy;
  * the plain versions against the JAX package on numpy-seeded inputs:
    `pow_static` and `prefix_mul` live (a module fixture, at widths
    tests/test_field.py compiles), `_combine_windows` against the limbs of
    `halo2_tpu.msm.msm._combine_windows` written once by
    tests/data/gen_torch_golden.py (its JAX call compiles for some 20 s);
  * that CPU tensors launch nothing and that the chain wrappers refuse them.

Tolerance: none — limb words and decoded values are compared for equality.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.fields import bn254 as jax_bn254

from halo2_tpu_torch.curves import cuda_point, g1, host
from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields import limbs as tl
from halo2_tpu_torch.fields.bn254 import FQ_MODULUS, FR_MODULUS, fq, fr
from halo2_tpu_torch.msm import msm
from halo2_tpu_torch.msm import sorted as msm_sorted
from halo2_tpu_torch.ntt import dft_matmul as dm

torch.set_num_threads(1)

HORNER_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "torch_golden_horner.json")
N_POW = 8       # the width tests/test_field.py uses for inv
N_SCAN = 37     # a ragged width: no multiple of either block below
EXPONENTS = {"0": 0, "1": 1, "2": 2, "p-2": FR_MODULUS - 2}


def _raw_ints(limbs):
    """The integers the limb words spell, without leaving Montgomery form."""
    arr = tl.to_numpy(limbs) if isinstance(limbs, torch.Tensor) \
        else np.asarray(limbs)
    return tl.limbs_to_ints(arr)


def _values(n, seed):
    """n canonical Fr values from a numpy seed, 0, 1 and p - 1 first."""
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(40), "little") % FR_MODULUS
          for _ in range(n)]
    xs[:3] = [0, 1, FR_MODULUS - 1]
    return xs


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result this module compares with, computed once."""
    JF = jax_bn254.Fr
    a = jnp.asarray(JF.encode(_values(N_POW, 11)))
    out = {("pow", k): _raw_ints(JF.pow_static(a, e))
           for k, e in EXPONENTS.items()}
    xs = [x or 7 for x in _values(N_SCAN, 12)]
    s = jnp.asarray(JF.encode(xs))
    for block in (4, 1024):
        out["prefix_rev", block] = _raw_ints(
            JF.prefix_mul(s, reverse=True, block=block))
    return out


# ---------------------------------------------------------------------------
# Plans of the launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e", [0, 1, 2, 0xFFFFFFFF, 1 << 32, FR_MODULUS - 2,
                               FQ_MODULUS - 2, (1 << 256) - 1])
def test_exponent_words(e):
    words, nbits = cuda_ops.exponent_words(e)
    assert len(words) == 8 and all(0 <= w < 1 << 32 for w in words)
    assert sum(w << (32 * k) for k, w in enumerate(words)) == e
    assert nbits == e.bit_length()


def test_exponent_words_refuse_what_the_kernel_cannot_hold():
    for e in (-1, 1 << 256):
        with pytest.raises(ValueError):
            cuda_ops.exponent_words(e)


@pytest.mark.parametrize("n", [1, 2, 511, 512, 4095, 4096, 4097, 65536,
                               65536 + 123, 1 << 18, 10 ** 6 + 1])
def test_scan_plan_covers_any_n(n):
    L, C, per = cuda_ops.scan_plan(n)
    assert L >= 1 and 1 <= C <= cuda_ops.SCAN_CHUNKS
    assert (C - 1) * L < n <= C * L          # no empty chunk, none missing
    assert per * cuda_ops.SCAN_THREADS >= C
    assert per <= cuda_ops.SCAN_CHUNKS // cuda_ops.SCAN_THREADS


def test_scan_plan_at_the_proof_sizes():
    assert cuda_ops.scan_plan(1 << 16) == (16, 4096, 8)
    assert cuda_ops.scan_plan(1 << 18) == (64, 4096, 8)
    with pytest.raises(ValueError):
        cuda_ops.scan_plan(0)


@pytest.mark.parametrize("es", [1, 2, 0])
def test_scan_origin_walks_backwards_when_reversed(es):
    n = 9
    start, step = cuda_ops.scan_origin(n, es, False)
    assert [start + j * step for j in range(n)] == [j * es for j in range(n)]
    start, step = cuda_ops.scan_origin(n, es, True)
    assert [start + j * step for j in range(n)] == \
        [(n - 1 - j) * es for j in range(n)]


def _model_scan(F, a, reverse):
    """The three passes of csrc/field_kernels.cu on cuda_ops' plan and
    origins, element by element on plain products: what the kernels
    compute, in their order."""
    n = a.shape[1]
    L, C, per = cuda_ops.scan_plan(n)
    a0, a_es = cuda_ops.scan_origin(n, a.stride(1), reverse)
    o0, o_es = cuda_ops.scan_origin(n, 1, reverse)
    out = torch.zeros((16, n), dtype=torch.int32)

    def load(j):
        return a.as_strided((16, 1), (a.stride(0), 1),
                            a.storage_offset() + a0 + j * a_es)

    def mul(x, y):
        return cuda_ops.plain_op("mul", F, x, y)

    one = F.one[:, None]
    totals = []
    for c in range(C):                            # pass 1
        j0, j1 = c * L, min(c * L + L, n)
        acc = load(j0)
        out[:, o0 + j0 * o_es] = acc[:, 0]
        for j in range(j0 + 1, j1):
            acc = mul(acc, load(j))
            out[:, o0 + j * o_es] = acc[:, 0]
        totals.append(acc)
    runs = []                                     # pass 2
    for t in range(cuda_ops.SCAN_THREADS):
        acc = one
        for c in range(t * per, min(t * per + per, C)):
            acc = mul(acc, totals[c])
        runs.append(acc)
    off = 1
    while off < cuda_ops.SCAN_THREADS:
        runs = [mul(runs[t - off], runs[t]) if t >= off else runs[t]
                for t in range(cuda_ops.SCAN_THREADS)]
        off *= 2
    excl = [None] * C
    for t in range(cuda_ops.SCAN_THREADS):
        ex = one if t == 0 else runs[t - 1]
        for c in range(t * per, min(t * per + per, C)):
            excl[c] = ex
            ex = mul(ex, totals[c])
    for j in range(L, n):                         # pass 3
        i = o0 + j * o_es
        out[:, i] = mul(out[:, i:i + 1], excl[j // L])[:, 0]
    return out


@pytest.mark.parametrize("n,reverse,stride",
                         [(23, False, 1), (23, True, 1), (16, True, 1),
                          (1, False, 1), (19, True, 3)])
def test_three_pass_model_on_the_plan_is_the_prefix_product(
        monkeypatch, n, reverse, stride):
    """A small plan (4 chunks, 2 threads in pass 2) so that every pass and
    the ragged last chunk do work at a width the CPU runs in a second."""
    monkeypatch.setattr(cuda_ops, "SCAN_CHUNKS", 4)
    monkeypatch.setattr(cuda_ops, "SCAN_THREADS", 2)
    F = fr("cpu")
    full = F.encode([x or 5 for x in _values(n * stride, 13)])
    a = full[:, ::stride]
    assert _raw_ints(_model_scan(F, a, reverse)) == \
        _raw_ints(F.plain_prefix_mul(a.contiguous(), reverse))


def test_horner_shape():
    assert cuda_point.horner_shape((16, 3, 24)) == (3, 24)
    assert cuda_point.horner_shape((16, 2, 2, 5)) == (4, 5)
    assert cuda_point.horner_shape((16, 7)) == (1, 7)
    for bad in ((16,), (15, 3, 2), (16, 3, 0)):
        with pytest.raises(ValueError):
            cuda_point.horner_shape(bad)


def test_binop_operand_strides():
    """What binop hands the kernel as (limb stride, element stride)
    without a copy, and where it materialises instead."""
    x = torch.zeros((16, 10), dtype=torch.int32)
    assert cuda_ops._rows(x, (16, 10), 10)[1:] == (10, 1)
    assert cuda_ops._rows(x[:, ::2], (16, 5), 5)[1:] == (10, 2)
    assert cuda_ops._rows(x[:, 3:4], (16, 1), 1)[1:] == (10, 0)
    assert cuda_ops._rows(x[:, 0], (16, 7), 7)[1:] == (10, 0)
    y = torch.zeros((16, 4, 6), dtype=torch.int32)
    assert cuda_ops._rows(y, (16, 4, 6), 24)[1:] == (24, 1)
    assert cuda_ops._rows(y[:, :, ::2], (16, 4, 3), 12) is None
    assert cuda_ops._rows(x[:, :1].expand(16, 4), (16, 5), 5) is None


def test_broadcast_against_an_empty_batch():
    """A size-1 batch dim meets a size-0 one as it does in numpy and JAX:
    the result is empty (binop's planner once took the larger size)."""
    F = fr("cpu")
    a = F.encode([3, 4])
    assert cuda_ops._broadcast(a[:, :1], a[:, :0])[2] == (16, 0)
    assert tuple(F.add(a[:, :1], a[:, :0]).shape) == (16, 0)
    assert tuple(F.mul(a[:, :0], a[:, 1:]).shape) == (16, 0)


# ---------------------------------------------------------------------------
# Plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(EXPONENTS))
def test_pow_static_matches_jax(jax_side, name):
    F = fr("cpu")
    xs = _values(N_POW, 11)
    e = EXPONENTS[name]
    got = F.pow_static(F.encode(xs), e)
    assert _raw_ints(got) == jax_side["pow", name]
    assert F.decode(got) == [pow(x, e, F.p) for x in xs]


@pytest.mark.parametrize("block", [4, 1024])
def test_prefix_mul_reversed_ragged_matches_jax(jax_side, block):
    F = fr("cpu")
    xs = [x or 7 for x in _values(N_SCAN, 12)]
    got = F.prefix_mul(F.encode(xs), reverse=True, block=block)
    assert _raw_ints(got) == jax_side["prefix_rev", block]


def test_combine_windows_matches_jax_golden():
    with open(HORNER_GOLDEN) as fh:
        golden = json.load(fh)
    Fq = fq("cpu")
    lanes = golden["inputs"]
    totals = tuple(
        torch.stack([Fq.encode([win[i] for win in wins]) for wins in lanes],
                    dim=1)
        for i in range(3))                        # (16, lanes, W)
    got = msm._combine_windows(totals, golden["c"])
    for lane, want in enumerate(golden["outputs_mont_words"]):
        assert [_raw_ints(c[:, lane:lane + 1])[0] for c in got] == want
    # and it is sum_w 2^(c w) T_w on the host curve
    for lane, wins in enumerate(lanes):
        acc = None
        for w, (X, Y, Z) in enumerate(wins):
            if Z:
                zi = pow(Z, FQ_MODULUS - 2, FQ_MODULUS)
                pt = (X * zi % FQ_MODULUS, Y * zi % FQ_MODULUS)
                acc = host.add(acc, host.mul(pt, 1 << (golden["c"] * w)))
        aff = g1.decode_points(g1.to_affine(
            tuple(c[:, lane:lane + 1] for c in got)))[0]
        assert aff == acc


def test_abel_doublings_follow_the_plain_combine():
    """The Abel sum's M * E_M goes through g1.horner (one window, log2(M)
    tail doublings; one launch on the card): limb for limb that many
    doublings, and 2^10 E_M on the host curve; and the Abel total at a
    small bucket count is sum_b b * Bucket_b, i.e. M * E_M - sum_{b<M} E_b,
    on the host curve."""
    rng = __import__("random").Random(1)
    pts = [host.random_point(rng) for _ in range(2)]
    p = g1.from_affine(tuple(g1.encode_points(pts, "cpu")))
    acc = p
    for _ in range(10):
        acc = g1.double(acc)
    via = g1.horner(tuple(c[..., None] for c in p), 0, 10)
    assert all(torch.equal(x, y) for x, y in zip(acc, via))
    assert g1.decode_points(g1.to_affine(via)) == \
        [host.mul(q, 1 << 10) for q in pts]
    assert msm_sorted.SIGNED_C_BITS - 1 == 10
    # two windows of nb = 5 boundary prefixes E_0..E_4 (M = 4)
    nb = 5
    e_host = [[host.random_point(rng) for _ in range(nb)] for _ in range(2)]
    flat = g1.from_affine(tuple(g1.encode_points(
        [q for row in e_host for q in row], "cpu")))
    e_pts = tuple(c.reshape(tl.N_LIMBS, 2, nb) for c in flat)
    got = g1.decode_points(g1.to_affine(
        msm_sorted._abel_window_totals(e_pts, nb)))
    for row, total in zip(e_host, got):
        want = host.mul(row[nb - 1], nb - 1)
        for q in row[:nb - 1]:
            want = host.add(want, host.neg(q))
        assert total == want


def test_plain_scalar_mul_on_edge_scalars():
    """Scalars 0, 1, all 256 bits set and a random one against the host
    curve (the ladder uses the bits as they are, unreduced)."""
    rng = __import__("random").Random(7)
    pts = [host.random_point(rng) for _ in range(4)]
    ks = [0, 1, (1 << 256) - 1, rng.randrange(FR_MODULUS)]
    x, y = g1.encode_points(pts, "cpu")
    s = tl.to_tensor(tl.ints_to_limbs_np(ks), "cpu")
    got = g1.decode_points(g1.to_affine(g1.scalar_mul((x, y), s)))
    assert got == [host.mul(p, k) for p, k in zip(pts, ks)]


# ---------------------------------------------------------------------------
# No launch from the CPU, no CPU tensor into a chain kernel
# ---------------------------------------------------------------------------

def _all_counts():
    return {**cuda_ops.launch_counts, **cuda_point.launch_counts,
            **dm.launch_counts}


def test_cpu_tensors_leave_every_launch_count_at_zero():
    for counts in (cuda_ops.launch_counts, cuda_point.launch_counts,
                   dm.launch_counts):
        for key in counts:
            counts[key] = 0
    F = fr("cpu")
    a = F.encode(_values(6, 14)[3:] + [5, 6, 9])
    F.inv(a)
    F.pow_static(a, 5)
    F.prefix_mul(a)
    F.prefix_mul(a, reverse=True)
    F.batch_inverse(a)
    F.mul(a, a[:, 0])
    pts = g1.encode_points(
        [host.random_point(__import__("random").Random(3))] * 2, "cpu")
    proj = g1.from_affine(tuple(pts))
    g1.scalar_mul(tuple(pts), tl.to_tensor(tl.ints_to_limbs_np([3, 5]),
                                           "cpu"))
    msm._combine_windows(tuple(c[:, None, :] for c in proj), 2)
    g1.to_affine(g1.add(g1.double(proj), proj))
    assert set(_all_counts().values()) == {0}
    assert {"pow", "scan"} <= set(cuda_ops.launch_counts)
    assert {"horner", "ladder"} <= set(cuda_point.launch_counts)


def test_chain_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: the CPU goes through the
    plain versions in fields/limbs.py, msm/msm.py and curves/g1.py."""
    F = fr("cpu")
    a = F.encode([1, 2, 3])
    with pytest.raises(ValueError):
        cuda_ops.pow_static(F, a, 3)
    with pytest.raises(ValueError):
        cuda_ops.prefix_mul(F, a)
    pts = g1.encode_points([host.random_point(__import__("random")
                                              .Random(4))], "cpu")
    proj = g1.from_affine(tuple(pts))
    with pytest.raises(ValueError):
        cuda_point.horner(tuple(c[:, None, :] for c in proj), 2)
    with pytest.raises(ValueError):
        cuda_point.scalar_mul(tuple(pts), tl.to_tensor(
            tl.ints_to_limbs_np([3]), "cpu"))
