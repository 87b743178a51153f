"""The chain entry points of kernels K1 and K4 (pow, inv, the prefix-product
scan, the Horner combine, the scalar ladder), on the CPU.

On the card each of these is one launch; here the tests hold what can run
without one:

  * the Python that plans the launches: the exponent's schedule, the scan's
    tile plan for any n, the reverse scan's origin and stride, the Horner
    combine's lane and window shape, the operand strides `binop` passes
    without a copy;
  * models of the two chain kernels of the batch inversion, written word
    for word after csrc/field_kernels.cu: the safegcd inverse (numpy,
    30-bit limbs, the kernel's batch count and constants, the final R^3
    product) against Python's pow(x, p - 2, p) and `plain_pow_static`, and
    the one-pass scan (tiles, runs, warp shuffles, the look-back over
    tiles whose steps interleave at random, the fold) against
    `plain_prefix_mul` on strided and reversed inputs;
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
import random

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
    """The pow kernel's schedule spells e back, in words that fit the
    kernel's step array (csrc/field_kernels.cu PowSchedule)."""
    plan = cuda_ops.pow_schedule(e)
    words = plan["words"]
    assert len(words) <= cuda_ops.POW_MAX_STEPS
    assert all(0 <= w < 1 << 16 and (w & 15) <= plan["entries"]
               for w in words)
    assert plan["entries"] <= 1 << (cuda_ops.POW_WINDOW_MAX - 1)
    if e == 0:
        assert plan["first"] == -1 and not words
        return
    got = 2 * plan["first"] + 1
    for w in words:
        got <<= w >> 4
        if w & 15:
            got += 2 * ((w & 15) - 1) + 1
    assert got == e


def test_exponent_words_refuse_what_the_kernel_cannot_hold():
    for e in (-1, 1 << 256):
        with pytest.raises(ValueError):
            cuda_ops.pow_schedule(e)


@pytest.mark.parametrize("n", [1, 2, 511, 512, 4095, 4096, 4097, 65536,
                               65536 + 123, 1 << 18, 10 ** 6 + 1, 1 << 22])
def test_scan_plan_covers_any_n(n):
    """One block a tile, the tiles covering n: the one pass grows with n
    and no pass runs on a fixed single block; a run longer than one
    element only where every SM still gets its tiles."""
    V, tiles = cuda_ops.scan_plan(n)
    tile = cuda_ops.SCAN_BLOCK * V
    assert V in cuda_ops.SCAN_PER_THREAD
    assert V == 1 or tiles >= cuda_ops.SCAN_MIN_TILES
    assert (tiles - 1) * tile < n <= tiles * tile   # no empty tile, none missing
    for v in cuda_ops.SCAN_PER_THREAD:              # V the longest run that fits
        if v > V:
            assert n < cuda_ops.SCAN_MIN_TILES * cuda_ops.SCAN_BLOCK * v


def test_scan_plan_at_the_proof_sizes():
    assert cuda_ops.scan_plan(1 << 16) == (2, 128)
    assert cuda_ops.scan_plan(1 << 17) == (4, 128)
    assert cuda_ops.scan_plan(1 << 18) == (8, 128)
    assert cuda_ops.scan_plan(5 << 16) == (8, 160)
    assert cuda_ops.scan_plan(1 << 22) == (8, 2048)
    assert cuda_ops.scan_plan(1000) == (1, 4)
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


def _storage_ints(a, span):
    """The raw integers of `span` elements of a's storage along its element
    axis, from its first element."""
    return _raw_ints(torch.as_strided(a, (16, span), (a.stride(0), 1),
                                      a.storage_offset()))


def _model_scan(F, a, reverse, V, lanes, seed):
    """The scan kernel of csrc/field_kernels.cu at run length V, on
    cuda_ops' tiles and origins, step for step on Python integers
    (Montgomery words, canonical products), with warps of `lanes` threads
    (32 on the card) and blocks of cuda_ops.SCAN_BLOCK threads.  The tiles are claimed in order; their
    steps interleave at random (seeded), and a look-back window waits, as
    the kernel spins, until each of its tiles has published."""
    n = a.shape[1]
    block = cuda_ops.SCAN_BLOCK
    tiles = -(-n // (block * V))
    T, warps = block * V, block // lanes
    a0, a_es = cuda_ops.scan_origin(n, a.stride(1), reverse)
    o0, o_es = cuda_ops.scan_origin(n, 1, reverse)
    store = _storage_ints(a, (n - 1) * a.stride(1) + 1)
    p, one, r_inv = F.p, F.R, F.R_inv
    out = [None] * n
    flags, agg, incl = [0] * tiles, [None] * tiles, [None] * tiles

    def mul(x, y):
        return x * y * r_inv % p

    def scan_up(vals):                         # shuffle-up Hillis-Steele
        d = 1
        while d < len(vals):
            vals = [mul(vals[l - d], v) if l >= d else v
                    for l, v in enumerate(vals)]
            d *= 2
        return vals

    def tree(vals, count):                     # shuffle-down tree: lane 0
        m = 1
        while m < count:
            vals = [mul(v, vals[l + m] if l + m < len(vals) else v)
                    for l, v in enumerate(vals)]
            m *= 2
        return vals[0]

    def tile_steps(tile):
        base = tile * T
        xs = [store[a0 + (base + i) * a_es] if base + i < n else one
              for i in range(T)]
        runs = []                              # 1-2. a thread's run
        for t in range(block):
            run = xs[t * V:(t + 1) * V]
            for v in range(1, V):
                run[v] = mul(run[v - 1], run[v])
            runs.append(run)
        tot = []                               # 3. the warps' scans
        for w in range(warps):
            tot += scan_up([r[-1] for r in runs[w * lanes:(w + 1) * lanes]])
        lane_pre = [one if t % lanes == 0 else tot[t - 1]
                    for t in range(block)]
        wt = scan_up([tot[(w + 1) * lanes - 1] for w in range(warps)])
        aggregate, wex = wt[-1], [one] + wt[:-1]
        if tile == 0:
            incl[0], flags[0] = aggregate, 2
        else:
            agg[tile], flags[tile] = aggregate, 1
        yield
        pre = [mul(wex[t // lanes], lane_pre[t]) for t in range(block)]
        if tile:                               # 4. the block's look-back
            end, window = tile - 1, 0
            while True:
                js = [end - t for t in range(block)]
                while any(j >= 0 and flags[j] == 0 for j in js):
                    yield                      # spin
                fl = [flags[j] if j >= 0 else 2 for j in js]
                vals = [(incl[j] if f == 2 else agg[j]) if j >= 0 else one
                        for j, f in zip(js, fl)]
                first = fl.index(2) if 2 in fl else block
                count = first + 1 if first < block else block
                vals = [v if t < count else one for t, v in enumerate(vals)]
                nw = -(-count // lanes)
                parts = [tree(vals[w * lanes:(w + 1) * lanes],
                              min(count - lanes * w, lanes))
                         for w in range(nw)]
                w_ = tree(parts + [one] * (lanes - nw), nw)
                before = mul(before, w_) if window else w_
                if first < block:
                    break
                end, window = end - block, window + 1
            incl[tile], flags[tile] = mul(before, aggregate), 2
            pre = [mul(before, x) for x in pre]
        yield
        for t in range(block):                 # 5. the fold
            for v in range(V):
                j = base + t * V + v
                if j < n:
                    out[o0 + j * o_es] = mul(pre[t], runs[t][v])

    rng = random.Random(seed)
    pending, active = list(range(tiles)), []
    while pending or active:
        if pending and (not active or rng.random() < 0.5):
            active.append(tile_steps(pending.pop(0)))
        else:
            g = rng.choice(active)
            try:
                next(g)
            except StopIteration:
                active.remove(g)
    return out


@pytest.mark.parametrize("n,reverse,stride",
                         [(23, False, 1), (23, True, 1), (16, True, 1),
                          (1, False, 1), (19, True, 3)])
def test_three_pass_model_on_the_plan_is_the_prefix_product(
        monkeypatch, n, reverse, stride):
    """The scan's three phases in its one pass (tile scan, look-back,
    fold), on a small plan: blocks of 4 threads in warps of 2, so that at
    a width the CPU runs in a second there are many tiles, look-back
    windows of 4 tiles that end on an aggregate, and ragged last tiles;
    every run length, two interleavings each."""
    monkeypatch.setattr(cuda_ops, "SCAN_BLOCK", 4)
    F = fr("cpu")
    full = F.encode([x or 5 for x in _values(n * stride, 13)])
    a = full[:, ::stride]
    want = _raw_ints(F.plain_prefix_mul(a.contiguous(), reverse))
    for v in cuda_ops.SCAN_PER_THREAD:
        for seed in (0, 1):
            assert _model_scan(F, a, reverse, v, 2, seed) == want


@pytest.mark.parametrize("seed", range(4))
def test_scan_model_with_the_cards_warps(monkeypatch, seed):
    """Warps of 32 lanes as on the card, 2 a block, a run of 1 or 2: the
    look-back's trees run at the card's width, and with 71 or 141 tiles a
    tile may need more than one window of 64 earlier tiles."""
    monkeypatch.setattr(cuda_ops, "SCAN_BLOCK", 64)
    F = fr("cpu")
    n = 64 * 140 + 7
    a = F.encode([x or 3 for x in _values(n, 20 + seed)])
    reverse = bool(seed & 1)
    want = _raw_ints(F.plain_prefix_mul(a, reverse))
    assert _model_scan(F, a, reverse, 1 + (seed >> 1), 32, seed) == want


# ---------------------------------------------------------------------------
# The safegcd inverse, word for word
# ---------------------------------------------------------------------------

M30 = (1 << 30) - 1


def _divsteps_30(delta, f, g):
    """divsteps_30 of csrc/field_kernels.cu on numpy words (uint32 wraps as
    the kernel's unsigned arithmetic does)."""
    u = np.ones_like(f)
    v = np.zeros_like(f)
    q = np.zeros_like(f)
    r = np.ones_like(f)
    for _ in range(cuda_ops.INV_DIVSTEPS):
        c1 = ((-delta) >> 31).view(np.uint32)
        c2 = np.uint32(0) - (g & np.uint32(1))
        x, y, z = (f ^ c1) - c1, (u ^ c1) - c1, (v ^ c1) - c1
        g, q, r = g + (x & c2), q + (y & c2), r + (z & c2)
        c1 = c1 & c2
        ci = c1.view(np.int32)
        delta = ((delta ^ ci) - ci) + np.int32(1)
        f, u, v = f + (g & c1), u + (q & c1), v + (r & c1)
        g, u, v = g >> np.uint32(1), u << np.uint32(1), v << np.uint32(1)
    return delta, [m.view(np.int32).astype(np.int64) for m in (u, v, q, r)]


def _update(x, y, m, p30=None, pinv30=None):
    """update_fg (p30 None) or update_de of the kernel: (x, y) <- m (x, y)
    / 2^30, with multiples of p added first for (d, e); int64 as the
    kernel's int64_t."""
    u, v, q, r = m
    cx = u * x[0] + v * y[0]
    cy = q * x[0] + r * y[0]
    if p30 is not None:
        sx, sy = x[8] >> 31, y[8] >> 31
        mx = (u & sx) + (v & sy)
        my = (q & sx) + (r & sy)
        mx -= (pinv30 * cx + mx) & M30
        my -= (pinv30 * cy + my) & M30
        cx += p30[0] * mx
        cy += p30[0] * my
    assert not (cx & M30).any() and not (cy & M30).any()
    cx >>= 30
    cy >>= 30
    for i in range(1, cuda_ops.INV_LIMBS):
        cx += u * x[i] + v * y[i]
        cy += q * x[i] + r * y[i]
        if p30 is not None:
            cx += p30[i] * mx
            cy += p30[i] * my
        x[i - 1], y[i - 1] = cx & M30, cy & M30
        cx >>= 30
        cy >>= 30
    x[8], y[8] = cx, cy


def _normalize(d, sign, p30):
    col = np.array(p30, dtype=np.int64)[:, None]

    def carry():
        for i in range(cuda_ops.INV_LIMBS - 1):
            d[i + 1] += d[i] >> 30
            d[i] &= M30
    d += col & (d[8] >> 31)
    neg = sign >> 31
    d[:] = (d ^ neg) - neg
    carry()
    d += col & (d[8] >> 31)
    carry()


def _model_inv(F, xs):
    """inv_kernel on canonical Montgomery words xs: the inverses' words.
    The limbs live in int64 arrays; every value the kernel keeps in an
    int32 fits one (the asserts and the final range say so)."""
    c = cuda_ops.inv_constants(F.p, F.R)
    n = len(xs)
    d = np.zeros((cuda_ops.INV_LIMBS, n), dtype=np.int64)
    e = np.zeros_like(d)
    e[0] = 1
    f = np.array(c["p30"], dtype=np.int64)[:, None].repeat(n, 1)
    g = np.array([[(x >> (30 * i)) & M30 for x in xs]
                  for i in range(cuda_ops.INV_LIMBS)], dtype=np.int64)
    delta = np.ones(n, dtype=np.int32)
    for _ in range(c["batches"]):
        delta, m = _divsteps_30(delta, f[0].astype(np.uint32),
                                g[0].astype(np.uint32))
        _update(d, e, m, c["p30"], c["pinv30"])
        _update(f, g, m)
    # g is 0, and f is +-gcd: +-1, or p where x is 0
    assert not g.any()
    assert [sum(int(f[i, j]) << (30 * i) for i in range(cuda_ops.INV_LIMBS))
            for j in range(n)] == [F.p if x == 0 else f_ for x, f_ in zip(
                xs, [1 if s >= 0 else -1 for s in f[8]])]
    _normalize(d, f[8].copy(), c["p30"])
    assert ((d >= 0) & (d <= M30)).all()
    assert (np.abs(delta) <= 1 + 30 * c["batches"]).all()
    r3 = sum(w << (32 * k) for k, w in enumerate(c["r3"]))
    ys = [sum(int(d[i, j]) << (30 * i) for i in range(cuda_ops.INV_LIMBS))
          for j in range(n)]
    return [y * r3 * F.R_inv % F.p for y in ys]       # the R^3 product


def test_inv_constants():
    """The batch count covers Bernstein-Yang's bound for 254-bit inputs,
    and the constants are what their names say."""
    bound = (49 * 254 + 57) // 17
    assert bound == 735
    assert cuda_ops.INV_DIVSTEPS * cuda_ops.INV_BATCHES >= bound
    for F in (fr("cpu"), fq("cpu")):
        assert F.p < 1 << 254
        c = cuda_ops.inv_constants(F.p, F.R)
        assert sum(l << (30 * i) for i, l in enumerate(c["p30"])) == F.p
        assert all(0 <= l <= M30 for l in c["p30"])
        assert c["pinv30"] * F.p % (1 << 30) == 1
        assert sum(w << (32 * k) for k, w in enumerate(c["r3"])) == \
            pow(F.R, 3, F.p)
        assert c["batches"] == cuda_ops.INV_BATCHES


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_inv_model_is_fermat(field):
    """The kernel's word-level model against pow(x, p - 2, p) and against
    `plain_pow_static(a, p - 2)`, limb for limb: 0, 1, 2, p - 1, R mod p,
    R^-1 mod p and 2,000 values from a numpy seed."""
    F = fr("cpu") if field == "Fr" else fq("cpu")
    rng = np.random.default_rng(30 if field == "Fr" else 31)
    xs = [0, 1, 2, F.p - 1, F.R, F.R_inv] + [
        int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(2000)]
    mont = [F.to_mont_int(x) for x in xs]
    got = _model_inv(F, mont)
    assert got == [F.to_mont_int(pow(x, F.p - 2, F.p)) for x in xs]
    a = tl.to_tensor(tl.ints_to_limbs_np(mont), "cpu")
    assert got == _raw_ints(F.plain_pow_static(a, F.p - 2))
    assert _raw_ints(F.inv(a[:, :50])) == got[:50]


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
    if e == F.p - 2:
        assert _raw_ints(F.inv(F.encode(xs))) == jax_side["pow", name]


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
    assert {"pow", "inv", "scan"} <= set(cuda_ops.launch_counts)
    assert {"horner", "ladder"} <= set(cuda_point.launch_counts)


def test_chain_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: the CPU goes through the
    plain versions in fields/limbs.py, msm/msm.py and curves/g1.py."""
    F = fr("cpu")
    a = F.encode([1, 2, 3])
    with pytest.raises(ValueError):
        cuda_ops.pow_static(F, a, 3)
    with pytest.raises(ValueError):
        cuda_ops.inv(F, a)
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
