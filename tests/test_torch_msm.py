"""halo2_tpu_torch MSM (the sorted Pippenger path whose scan step is kernel
K5) against the host big-int curve and the JAX package, on the CPU.

The same points and scalars, made from a seed, go through
`halo2_tpu.msm.msm` (on the CPU backend that is exact host math below 8192
points), through `curves.host.msm`, and through the port with CPU tensors.
Tolerance: none — the resulting points are compared for equality.
"""

import random

import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.curves import g1 as jg1
from halo2_tpu.fields.bn254 import Fr as JFr
from halo2_tpu.msm import msm_host_result as j_msm_host_result

from halo2_tpu_torch.curves import cuda_point, g1, host
from halo2_tpu_torch.fields import limbs as tl
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as R
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.msm import sorted as msm_sorted
from halo2_tpu_torch.msm.msm import (_block_for, msm, msm_host_result,
                                     window_bits_for)

torch.set_num_threads(1)

_rng = random.Random(0x5EED)
POINTS = [host.random_point(_rng) for _ in range(40)]


def _case(kind, n):
    rng = random.Random(f"{kind}-{n}")
    if kind == "random":
        scalars = [rng.randrange(R) for _ in range(n)]
        scalars[0] = R - 1
    elif kind == "all_equal":
        scalars = [rng.randrange(R)] * n
    elif kind == "zero":
        scalars = [0] * n
    elif kind == "zeros_and_ones":
        scalars = [i % 2 for i in range(n)]
    else:  # bounded
        scalars = [rng.randrange(1 << 16) for _ in range(n)]
    return POINTS[:n], scalars


CASES = [("random", 16, 256), ("random", 13, 256), ("all_equal", 16, 256),
         ("zero", 8, 256), ("zeros_and_ones", 9, 256), ("bounded", 16, 16),
         ("random", 1, 256), ("random", 40, 256)]


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for kind, n, max_bits in CASES:
        pts, scalars = _case(kind, n)
        dev = jg1.encode_points(pts)
        out[kind, n] = j_msm_host_result(
            (dev[0], dev[1]), jnp.asarray(JFr.encode(scalars)),
            max_bits=max_bits)
    return out


@pytest.mark.parametrize("kind,n,max_bits", CASES)
def test_msm_matches_host_and_jax(jax_side, kind, n, max_bits):
    pts, scalars = _case(kind, n)
    dev = g1.encode_points(pts, "cpu")
    got = msm_host_result((dev[0], dev[1]), fr("cpu").encode(scalars),
                          max_bits=max_bits)
    assert got == host.msm(pts, scalars)
    assert got == jax_side[kind, n]


def test_result_is_projective_limbs():
    pts, scalars = _case("bounded", 4)
    dev = g1.encode_points(pts, "cpu")
    proj = msm((dev[0], dev[1]), fr("cpu").encode(scalars), max_bits=16)
    assert len(proj) == 3 and all(c.shape == (16,) for c in proj)
    with pytest.raises(ValueError):
        msm((dev[0][:, :0], dev[1][:, :0]), fr("cpu").encode([]))


@pytest.mark.parametrize("c", [4, 8, 11])
def test_signed_digits_recompose(c):
    rng = random.Random(c)
    scalars = [rng.randrange(R) for _ in range(20)] + [0, 1, R - 1]
    std = tl.to_tensor(tl.ints_to_limbs_np(scalars), "cpu")
    w = msm_sorted.num_windows_for(254, c)
    mag, neg = msm_sorted._signed_digits(std, w, c)
    assert int(mag.max()) <= 1 << (c - 1) and int(mag.min()) >= 0
    for i, s in enumerate(scalars):
        total = sum((-1 if int(neg[j, i]) else 1) * int(mag[j, i]) << (c * j)
                    for j in range(w))
        assert total == s


@pytest.mark.parametrize("bits,c,want", [(254, 11, 24), (256, 11, 24),
                                         (16, 11, 2), (9, 11, 1),
                                         (20, 11, 2), (254, 4, 64)])
def test_num_windows_for(bits, c, want):
    assert msm_sorted.num_windows_for(bits, c) == want


def test_bucket_ends_and_block_rules():
    d = torch.tensor([[0, 2, 2, 1], [3, 3, 3, 3]], dtype=torch.int32)
    ends = cuda_point.bucket_ends(d, 5)
    assert ends.tolist() == [[0, 1, 3, 3, 3], [-1, -1, -1, 3, 3]]
    assert [_block_for(n) for n in (1, 2, 13, 16, 1000, 2048, 5000)] == \
        [1, 2, 16, 16, 1024, 2048, 2048]
    assert [window_bits_for(b) for b in (1, 16, 1024, 2048)] == [4, 4, 10, 11]
    assert msm_sorted.auto_group(1 << 16, 24) == 24
    # 64 bytes a point and window: one group to 2^21 points, two of 12 at
    # 2^22
    assert msm_sorted.auto_group(1 << 21, 24) == 24
    assert msm_sorted.auto_group(1 << 22, 24) == 12


def test_exclusive_scan_and_tree_sum_of_points():
    n = 8
    dev = g1.encode_points(POINTS[:n], "cpu")
    proj = g1.from_affine((dev[0], dev[1]))
    proj = tuple(c.reshape(16, 1, n) for c in proj)
    excl = msm_sorted._hs_exclusive(proj)
    decoded = g1.decode_points(g1.to_affine(
        tuple(c.reshape(16, n) for c in excl)))
    acc, want = None, []
    for p in POINTS[:n]:
        want.append(acc)
        acc = host.add(acc, p)
    assert decoded == want
    total = msm_sorted._sum_points_lastaxis(proj)
    assert g1.decode_points(g1.to_affine(total)) == [acc]
    # the two-level scan agrees with the flat ladder
    two = msm_sorted._exclusive_scan_points(proj, seq=2)
    assert g1.decode_points(g1.to_affine(
        tuple(c.reshape(16, n) for c in two))) == want
