"""The MSM's bucket path (msm/msm.py below SORT_BLOCK points, kernel
`cuda_point.msm_bucket`) on the CPU, against the JAX package.

The same points and scalars, made from a seed, go through the port's
bucket path (`force_scatter=True`: the kernel's plain version, the JAX
package's lane-private buckets) and through `halo2_tpu.curves.host.msm`,
the exact host MSM the JAX package's own CPU path runs; `_digits` and
`_pick_lanes` are held to the JAX functions on the same inputs, and a
model of the kernel's block (its counting sort, suffix scan and tree, on
integers) to the sum it stands for.  Tolerance: none, the points are
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
Q = (1 << 61) - 1                            # the model's group: Z / Q


def _model_row(values, digits, chunk):
    """One block's work on one row, step for step as the kernel makes it
    (thread b is index b), with points as integers mod Q and 0 the
    identity: per chunk a histogram, its Hillis-Steele scan, the scatter of
    point indices (in index order here: any order gives the same sum) and
    each thread's walk of its bucket; then the suffix scan with the
    identity skipped, slot 0 dropped and the halving tree."""
    n = len(digits)
    acc = [0] * NB
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        count = [0] * NB
        for t in range(m):
            d = digits[c0 + t] & (NB - 1)
            if d:
                count[d] += 1
        fill = list(count)
        s = 1
        while s < NB:
            v = [fill[b - s] if b >= s else 0 for b in range(NB)]
            fill = [f + x for f, x in zip(fill, v)]
            s <<= 1
        start = [fill[b] - count[b] for b in range(NB)]
        cursor = list(start)
        lst = [None] * chunk
        for t in range(m):
            d = digits[c0 + t] & (NB - 1)
            if d:
                lst[cursor[d]] = c0 + t
                cursor[d] += 1
        for b in range(NB):
            for j in range(start[b], start[b] + count[b]):
                acc[b] = (acc[b] + values[lst[j]]) % Q

    def add_skip(p, q):
        return p if q == 0 else q if p == 0 else (p + q) % Q

    slot = list(acc)
    s = 1
    while s < NB:
        other = [slot[b + s] if b + s < NB else 0 for b in range(NB)]
        slot = [add_skip(slot[b], other[b]) if b + s < NB else slot[b]
                for b in range(NB)]
        s <<= 1
    slot[0] = 0
    h = NB // 2
    while h >= 1:
        slot = [add_skip(slot[b], slot[b + h]) if b < h else slot[b]
                for b in range(NB)]
        h >>= 1
    return slot[0]


@pytest.mark.parametrize("n,chunk", [(1, 2048), (23, 5), (300, 64),
                                     (600, 256)])
def test_kernel_block_model(n, chunk):
    rng = np.random.default_rng(n)
    values = [int(v) for v in rng.integers(1, Q, n)]
    digits = [int(d) for d in rng.integers(0, NB, n)]
    if n > 3:
        digits[:3] = [0, 255, 255]
    want = sum(d * v for d, v in zip(digits, values)) % Q
    assert _model_row(values, digits, chunk) == want


def test_kernel_block_model_all_zero_and_one_bucket():
    values = [7, 11, 13]
    assert _model_row(values, [0, 0, 0], 2) == 0
    assert _model_row(values, [9, 9, 9], 2) == 9 * 31 % Q


def test_port_digits_cover_the_scalar():
    """The 32 byte digits of a standard-form scalar put it back together:
    sum_w d_w 2^(8w) = s, for 0, 1, r - 1 and a random scalar."""
    scalars = [0, 1, R - 1, random.Random(9).randrange(R)]
    limbs = torch.from_numpy(ints_to_limbs_np(scalars).astype(np.int32))
    d = msm_mod._digits(limbs, 32).numpy()
    for i, s in enumerate(scalars):
        assert sum(int(d[w, i]) << (8 * w) for w in range(32)) == s
