"""The MSM's bucket path (msm/msm.py below SORT_BLOCK points, kernel
`cuda_point.msm_bucket`) on the CPU, against the JAX package.

The same points and scalars, made from a seed, go through the port's
bucket path (`force_scatter=True`: the kernel's plain version, the JAX
package's lane-private buckets) and through `halo2_tpu.curves.host.msm`,
the exact host MSM the JAX package's own CPU path runs; `_digits` and
`_pick_lanes` are held to the JAX functions on the same inputs, and a
model of the kernel's block (its counting sort, the fill balanced by
points, the chains' segmented scan, the radix and bit-plane reduction, on
integers) to the sum it stands for, its counts of point operations to
`cuda_point.msm_bucket_ops`.  Tolerance: none, the points are
compared for equality.  The plain buckets cost a complete add per bucket
and lane, so the cases stay at n <= 16, at most 16-bit scalars (two
windows) and at most 4 lanes.
"""

import importlib
import random

import numpy as np
import pytest
import torch

from halo2_tpu.curves import host as jhost

from halo2_tpu_torch.curves import cuda_point, g1
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as R
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.fields.limbs import N_LIMBS, ints_to_limbs_np
from halo2_tpu_torch.msm import msm as msm_mod
from halo2_tpu_torch.msm import sorted as msm_sorted
from halo2_tpu_torch.msm.msm import msm_host_result, msm_many

# the module: the package's `msm` is its function
jmsm = importlib.import_module("halo2_tpu.msm.msm")

torch.set_num_threads(1)

_rng = random.Random(0xB0C7)
POINTS = [jhost.random_point(_rng) for _ in range(16)]


def _case(name):
    """(n, scalars, lanes, max_bits) of the JAX package's tests/test_msm.py
    cases, at 16-bit scalars."""
    rng = random.Random(name)
    small = [rng.randrange(1 << 16) for _ in range(16)]
    return {
        "small": (8, small[:8], 4, 16),
        "zeros_and_ones": (8, [0, 1, 0, 1, 2, 0xFFFF, 0, 12345], 4, 16),
        "all_zero": (4, [0, 0, 0, 0], 2, 16),
        "nondivisible_lanes": (7, small[:7], 4, 16),   # pads to 8
        "single_point": (1, small[:1], 1, 16),
        "one_window": (16, [s & 0xFF for s in small], 4, 8),
        "default_lanes": (12, small[:12], None, 16),   # _pick_lanes: 4
    }[name]


CASES = ["small", "zeros_and_ones", "all_zero", "nondivisible_lanes",
         "single_point", "one_window", "default_lanes"]


def _encode(pts, scalars):
    dev = g1.encode_points(pts, "cpu")
    return (dev[0], dev[1]), fr("cpu").encode(scalars)


@pytest.mark.parametrize("name", CASES)
def test_bucket_path_matches_jax_host(name):
    n, scalars, lanes, max_bits = _case(name)
    pts, scal = _encode(POINTS[:n], scalars)
    got = msm_host_result(pts, scal, max_bits=max_bits, lanes=lanes,
                          force_scatter=True)
    assert got == jhost.msm(POINTS[:n], scalars)


def test_bucket_path_of_several_columns_of_two_widths():
    """One msm_many, two columns (16-bit: two windows; 8-bit: one, padded
    with an identity window), one bucket launch and one Horner pass."""
    rng = random.Random(5)
    n = 6
    cols = [[rng.randrange(1 << 16) for _ in range(n)],
            [rng.randrange(1 << 8) for _ in range(n)]]
    (px, py), _ = _encode(POINTS[:n], cols[0])
    out = msm_many((px, py), [fr("cpu").encode(c) for c in cols], [16, 8],
                   lanes=2, force_scatter=True)
    got = g1.decode_points(g1.to_affine(out))
    assert got == [jhost.msm(POINTS[:n], c) for c in cols]


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_plain_msm_bucket_rows(lanes):
    """plain_msm_bucket on raw digit rows: row r is sum_i d[r, i] * P_i."""
    rng = np.random.default_rng(lanes)
    n = 8
    digits = rng.integers(0, 256, (3, n), dtype=np.int32)
    digits[1] = 0                            # a row of the discard bucket
    digits[2, :4] = 255
    pts = POINTS[:n]
    (px, py), _ = _encode(pts, [0] * n)
    out = cuda_point.plain_msm_bucket(px, py, torch.from_numpy(digits),
                                      lanes)
    got = g1.decode_points(g1.to_affine(out))
    assert got == [jhost.msm(pts, [int(d) for d in row]) for row in digits]


def test_digits_match_jax():
    rng = np.random.default_rng(3)
    limbs = rng.integers(0, 1 << 16, (N_LIMBS, 9), dtype=np.uint32)
    for W in (1, 2, 17, 32):
        want = np.asarray(jmsm._digits(limbs, W))
        got = msm_mod._digits(torch.from_numpy(limbs.astype(np.int32)), W)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_pick_lanes_and_windows_match_jax():
    for n in list(range(1, 300)) + [511, 512, 1000, 1024, 2047]:
        assert msm_mod._pick_lanes(n) == jmsm._pick_lanes(n), n
    for bits in (1, 8, 9, 16, 17, 254, 256, 300):
        assert msm_mod.bucket_windows(bits) == min((bits + 7) // 8, 32)


def test_dispatch_by_device(monkeypatch):
    """A CPU msm_many below SORT_BLOCK points takes the sorted path (the
    JAX package's CPU path is host arithmetic, which the port does not
    carry); force_scatter takes the bucket path."""
    calls = []
    real_bucket, real_scan = cuda_point.msm_bucket, cuda_point.msm_scan
    monkeypatch.setattr(cuda_point, "msm_bucket", lambda *a: calls.append(
        "bucket") or real_bucket(*a))
    monkeypatch.setattr(cuda_point, "msm_scan", lambda *a: calls.append(
        "scan") or real_scan(*a))
    n, scalars, _, _ = _case("small")
    pts, scal = _encode(POINTS[:n], scalars)
    assert msm_mod.SORT_BLOCK == 2048
    sorted_ = msm_host_result(pts, scal, max_bits=16)
    assert calls == ["scan"]
    calls.clear()
    bucket = msm_host_result(pts, scal, max_bits=16, force_scatter=True)
    assert calls == ["bucket"]
    assert sorted_ == bucket == jhost.msm(POINTS[:n], scalars)


def test_horner_at_c8_over_fewer_windows():
    """The bucket path's combine: acc = T[W-1], 8 doublings and an add a
    window, W = 3 < 32, against sum_w 2^(8w) T_w."""
    pts = POINTS[:3]
    (px, py), _ = _encode(pts, [0] * 3)
    totals = tuple(c[:, None, :] for c in g1.from_affine((px, py)))
    got = g1.decode_points(g1.to_affine(g1.horner(totals, 8)))
    assert got == [jhost.msm(pts, [1, 1 << 8, 1 << 16])]


def test_msm_bucket_checks_its_operands():
    (px, py), _ = _encode(POINTS[:4], [0] * 4)
    digits = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of lanes"):
        cuda_point.msm_bucket(px, py, digits, 3)
    with pytest.raises(ValueError, match="digits must be"):
        cuda_point.msm_bucket(px, py, digits[:, :3], 1)
    with pytest.raises(TypeError):
        cuda_point.msm_bucket(px, py, digits.to(torch.int64), 1)
    with pytest.raises(ValueError, match="expected"):
        cuda_point.msm_bucket(px[:8], py, digits, 1)


def test_msm_mem_overrides_the_group_budget(monkeypatch):
    n, W = 1 << 16, 24
    monkeypatch.delenv("HALO2_TPU_MSM_MEM", raising=False)
    assert msm_sorted.auto_group(n, W) == W
    per_window = msm_sorted.GROUP_BYTES_PER_POINT_WINDOW * n
    monkeypatch.setenv("HALO2_TPU_MSM_MEM", str(8 * per_window))
    assert msm_sorted.auto_group(n, W) == 8
    monkeypatch.setenv("HALO2_TPU_MSM_MEM", "1")
    assert msm_sorted.auto_group(n, W) == 1


# ---------------------------------------------------------------------------
# A model of msm_bucket_kernel's block (csrc/point_kernels.cu), on integers
# ---------------------------------------------------------------------------

NB = cuda_point.BUCKETS
CHUNK = cuda_point.BUCKET_CHUNK
Q = (1 << 61) - 1                            # the model's group: Z / Q


class _Group:
    """Z / Q with 0 the identity, counting the operations the kernel makes:
    an add with the identity on either side is skipped, as the kernel's
    add_skip_identity / add_skip_grouped skip it, and so is a doubling of
    the identity."""

    def __init__(self):
        self.ops = {"mixed_adds": 0, "complete_adds": 0, "doublings": 0}

    def add(self, p, q):
        if q == 0:
            return p
        if p == 0:
            return q
        self.ops["complete_adds"] += 1
        return (p + q) % Q

    def add_mixed(self, p, v):
        self.ops["mixed_adds"] += 1
        return (p + v) % Q

    def double(self, p, times):
        for _ in range(times if p else 0):
            self.ops["doublings"] += 1
            p = 2 * p % Q
        return p


def _with_bit(k, j):
    """The k-th (0..7) of the 16 indices whose bit j is set."""
    return ((k >> j) << (j + 1)) | (1 << j) | (k & ((1 << j) - 1))


def _radix_pair(half, d_in, item):
    if item < half:
        return 2 * item, 2 * item + 1
    q = item - half
    u = d_in + 32 * (q >> 4) + (q & 15)
    return u, u + 16


def _model_reduce(S, G):
    """The kernel's reduction of one row's 256 bucket slots S (slot 0 the
    identity), its two slot arrays S and V in turn: four radix rounds (b =
    16 h + l: the row sums C_h into slots 0..15, the column sums D_l into
    16..31; round 1 leaves C_0 and D_0, of weight 0, at the identity), the
    8 bit planes (plane j sums the D_l, j < 4, or C_h, j >= 4, whose bit
    j & 3 is set: a pair, then 16 and 8 adds), then sum_j 2^j F_j as
    x + 2 y, x + 4 y, x + 16 y."""
    S = list(S)
    V = [0] * NB
    for t in range(NB):                                   # round 1
        u, w = _radix_pair(NB // 2, 0, t)
        used = t >= 8 if t < NB // 2 else t & 15 != 0
        V[t] = G.add(S[u], S[w]) if used else 0
    for t in range(NB // 2):                              # round 2
        S[t] = G.add(*(V[x] for x in _radix_pair(NB // 4, NB // 2, t)))
    for it in range(NB // 4):                             # round 3, groups
        V[it] = G.add(*(S[x] for x in _radix_pair(NB // 8, NB // 4, it)))
    for g in range(NB // 8):                              # round 4, groups
        S[g] = G.add(*(V[x] for x in _radix_pair(NB // 16, NB // 8, g)))
    for g in range(32):                                   # the bit planes
        plane, p = g >> 2, g & 3
        base = 16 if plane < 4 else 0
        V[g] = G.add(S[base + _with_bit(2 * p, plane & 3)],
                     S[base + _with_bit(2 * p + 1, plane & 3)])
    for g in range(16):
        S[g] = G.add(V[2 * g], V[2 * g + 1])
    for g in range(8):
        V[g] = G.add(S[2 * g], S[2 * g + 1])
    for g in range(4):
        S[g] = G.add(V[2 * g], G.double(V[2 * g + 1], 1))
    for g in range(2):
        V[g] = G.add(S[2 * g], G.double(S[2 * g + 1], 2))
    return G.add(V[0], G.double(V[1], 4))


def _model_row(values, digits, chunk=CHUNK, G=None, seed=0, T=NB):
    """One block's work on one row, step for step as the kernel makes it
    in a block of T threads (thread t is index t), with points as integers
    mod Q (never 0) and 0 the identity.  Per chunk: a histogram, the
    buckets' starts (each thread's K = 256 / T buckets summed, a
    Hillis-Steele scan over the threads), the scatter of (digit << 16 |
    index) (in a random order: the kernel's atomics fix none); then the
    fill, thread t taking the L = ceil(M / T) listed positions from t L
    on, piece by piece (a piece's first point
    opens it, the rest are mixed adds), every piece but the run's last
    added to its bucket's slot; the chains of last pieces summed by a
    segmented Hillis-Steele scan over the threads for as many rounds as
    the longest chain needs; the last piece's chain added to its bucket
    where the bucket ends with the run, and to the slot of a first piece
    whose bucket began before its run, the chain of its predecessor.  Then
    the reduction (_model_reduce)."""
    G = G or _Group()
    rng = random.Random(seed)
    n = len(digits)
    S = [0] * NB
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        count = [0] * NB
        for i in range(m):
            d = digits[c0 + i] & (NB - 1)
            if d:
                count[d] += 1
        K = NB // T
        mine = [sum(count[t * K:t * K + K]) for t in range(T)]
        incl = list(mine)
        s = 1
        while s < T:
            incl = [incl[t] + (incl[t - s] if t >= s else 0)
                    for t in range(T)]
            s <<= 1
        start = []
        for t in range(T):
            run = incl[t] - mine[t]
            for j in range(K):
                start.append(run)
                run += count[t * K + j]
        start.append(incl[T - 1])
        cursor = start[:NB]
        lst = [None] * m
        for i in rng.sample(range(m), m):
            d = digits[c0 + i] & (NB - 1)
            if d:
                lst[cursor[d]] = (d << 16) | i
                cursor[d] += 1
        M = start[NB]
        V, state = [0] * T, []
        L = -(-M // T)
        for t in range(T):                                # the fill
            a = min(t * L, M)
            e = min(a + L, M)
            part, pb, hb = 0, 0, 0
            for j in range(a, e):
                d, i = lst[j] >> 16, c0 + (lst[j] & 0xFFFF)
                if d != pb:
                    if pb:
                        if start[pb] < a:
                            hb = pb
                        S[pb] = G.add(S[pb], part)
                    part, pb = values[i], d
                else:
                    part = G.add_mixed(part, values[i])
            first = start[pb] // L if pb and start[pb] < a else t
            V[t] = part
            state.append((a, e, pb, hb, first))
        span = max(t - st[4] + 1 for t, st in enumerate(state))
        s = 1
        while s < span:                                   # the chains
            V = [G.add(V[t], V[t - s]) if t - s >= state[t][4] else V[t]
                 for t in range(T)]
            s <<= 1
        for t, (a, e, pb, hb, _) in enumerate(state):
            if a < e and start[pb + 1] == e:
                S[pb] = G.add(S[pb], V[t])
            if hb:
                S[hb] = G.add(S[hb], V[t - 1])
    return _model_reduce(S, G)


def _check_model(values, digits, chunk=CHUNK, threads=(NB, NB // 2)):
    """The model in blocks of 256 and of 128 threads against sum d * v,
    and its operation counts against cuda_point.msm_bucket_ops."""
    want = sum(d * v for d, v in zip(digits, values)) % Q
    for T in threads:
        G = _Group()
        assert _model_row(values, digits, chunk, G, T=T) == want
        if chunk == CHUNK:
            assert G.ops == cuda_point.msm_bucket_ops([digits], T)


def _values(n, seed):
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(1, Q, n)]


@pytest.mark.parametrize("n,chunk", [(1, 2048), (23, 5), (300, 64),
                                     (600, 256)])
def test_kernel_block_model(n, chunk):
    rng = np.random.default_rng(n)
    values = _values(n, n)
    digits = [int(d) for d in rng.integers(0, NB, n)]
    if n > 3:
        digits[:3] = [0, 255, 255]
    _check_model(values, digits, chunk)


def test_kernel_block_model_all_zero_and_one_bucket():
    values = [7, 11, 13]
    for T in (NB, NB // 2):
        assert _model_row(values, [0, 0, 0], 2, T=T) == 0
        assert _model_row(values, [9, 9, 9], 2, T=T) == 9 * 31 % Q


def _digit_rows():
    """Rows the new fill and chains are most exposed on, by name."""
    rng = np.random.default_rng(7)
    n = 2047
    rows = {
        # the top window of canonical and of 254-bit scalars
        "crowded_0x30": rng.integers(1, 0x31, n),
        "crowded_0x3f": rng.integers(1, 0x40, n),
        # n = 16: runs of one point, most threads without any
        "sparse_16": rng.integers(0, NB, 16),
        # 1,792 points of bucket 1 (a chain of 224 threads), then 255 of
        # one point each: runs of 8 positions crossing 8 buckets
        "runs_cross_buckets": np.concatenate(
            [np.ones(1792, dtype=np.int64), np.arange(1, 256)]),
        # every digit one bucket: one chain of all 256 threads
        "one_bucket": np.full(n, 7),
        "mostly_zero": np.where(rng.random(n) < 0.9, 0,
                                rng.integers(0, NB, n)),
        "dense_512": rng.integers(0, NB, 512),
    }
    return {k: [int(x) for x in v] for k, v in rows.items()}


@pytest.mark.parametrize("name", sorted(_digit_rows()))
def test_kernel_block_model_rows(name):
    digits = _digit_rows()[name]
    _check_model(_values(len(digits), len(digits)), digits)


@pytest.mark.parametrize("n,chunk", [(4101, CHUNK), (2 * 64 + 5, 64),
                                     (257, 256)])
def test_kernel_block_model_chunk_boundaries(n, chunk):
    """More than one chunk: a bucket's points fall in several chunks, and
    its slot adds each chunk's sum to the earlier ones'."""
    rng = np.random.default_rng(n)
    digits = [int(d) for d in rng.integers(0, 12, n)]
    digits[chunk - 1:chunk + 1] = [5, 5]            # across the boundary
    _check_model(_values(n, n + 1), digits, chunk)


@pytest.mark.parametrize("kind", ["random", "identity", "single_1",
                                  "single_16", "single_17", "single_255",
                                  "row_h0", "column_l0"])
def test_kernel_reduction_model(kind):
    """The reduction alone against sum_b b S_b, for random bucket values,
    no bucket at all, one bucket (of weight 1, 16, 17, 255), and the
    buckets only below 16 (h = 0) or only at l = 0."""
    rng = np.random.default_rng(len(kind))
    S = [0] + [int(v) for v in rng.integers(1, Q, NB - 1)]
    if kind == "identity":
        S = [0] * NB
    elif kind.startswith("single_"):
        b = int(kind.split("_")[1])
        S = [S[b] if x == b else 0 for x in range(NB)]
    elif kind == "row_h0":
        S = [v if x < 16 else 0 for x, v in enumerate(S)]
    elif kind == "column_l0":
        S = [v if x % 16 == 0 else 0 for x, v in enumerate(S)]
    G = _Group()
    assert _model_reduce(S, G) == sum(b * v for b, v in enumerate(S)) % Q
    if kind == "random":
        # 450 radix adds, 56 for the bit planes, 7 for their sum
        assert G.ops == {"mixed_adds": 0, "complete_adds": 513,
                         "doublings": 12}


def test_kernel_ops_of_a_dense_row_are_the_running_sums():
    """The kernel's complete adds on a dense row of 512 points stay within
    a quarter of the suffix scan's (some 2,050) and near the running
    sum's 508 (chip_smoke.py's function count)."""
    digits = _digit_rows()["dense_512"]
    ops = cuda_point.msm_bucket_ops([digits])
    assert ops["complete_adds"] < 2050 // 4 + 120
    assert ops["mixed_adds"] < len(digits)


def test_port_digits_cover_the_scalar():
    """The 32 byte digits of a standard-form scalar put it back together:
    sum_w d_w 2^(8w) = s, for 0, 1, r - 1 and a random scalar."""
    scalars = [0, 1, R - 1, random.Random(9).randrange(R)]
    limbs = torch.from_numpy(ints_to_limbs_np(scalars).astype(np.int32))
    d = msm_mod._digits(limbs, 32).numpy()
    for i, s in enumerate(scalars):
        assert sum(int(d[w, i]) << (8 * w) for w in range(32)) == s
