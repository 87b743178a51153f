"""The MSM's bucket scan of a window group (`cuda_point.msm_scan`, one launch
a group on the card) and the Horner kernel's level schedule, on the CPU.

  * the scan's plain version, and `window_totals` through it, against the
    JAX package's `_prefix_scan_group` + `_bucket_ends` +
    `_gather_boundary_prefix` (c = 4, block 4, S = 5 and 1 steps a block,
    1 to 5 windows), whose projective limbs tests/data/gen_torch_golden.py
    wrote once to tests/data/torch_golden_scan.json (each batch shape
    compiles for some 35 s on the CPU); the windows hold the edge cases:
    random digits, every digit equal, only digit 0 and the top bucket,
    every sign set, empty buckets between full ones, the signed digits of
    scalars;
  * a numpy model of the kernel's write rule (which lane writes which
    (window, digit) slot of the boundary table) against `_bucket_ends` of
    both packages;
  * curves/formulas.py's level schedule (the Horner kernel's) against
    `plain_point` on P, P + P, P + (-P) and the identity.

Tolerance: none — limb words and decoded points are compared for equality.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.msm import sorted as jsorted

from halo2_tpu_torch.curves import cuda_point, formulas, g1, host
from halo2_tpu_torch.fields import limbs as tl
from halo2_tpu_torch.fields.bn254 import fq, fr
from halo2_tpu_torch.msm import sorted as msm_sorted

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_scan.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


def _nb(golden):
    return (1 << (golden["c"] - 1)) + 1


def _inputs(batch, windows):
    """rows, order and sorted key of a golden batch's `windows`."""
    xy = g1.encode_points([tuple(p) for p in batch["points"]], "cpu")
    rows = msm_sorted.pack_xy(xy[0], xy[1]).t().contiguous()
    mag = np.asarray(batch["mag"])[windows]
    neg = np.asarray(batch["neg"])[windows]
    order = np.asarray(batch["order"])[windows]
    key = np.take_along_axis((mag << 1) | neg, order, axis=1)
    return (rows, torch.from_numpy(order).long(),
            torch.from_numpy(key.astype(np.int32)).contiguous())


def _words(c):
    """(16, *B) limbs -> nested lists over *B of the ints they spell."""
    arr = tl.to_numpy(c)
    flat = tl.limbs_to_ints(arr.reshape(16, -1))
    return np.asarray(flat, dtype=object).reshape(arr.shape[1:]).tolist()


def _golden_points(coords, windows):
    return [np.asarray(c, dtype=object)[windows].tolist() for c in coords]


def _golden_tensor(words):
    arr = np.asarray(words, dtype=object)
    limbs = tl.ints_to_limbs_np([int(v) for v in arr.reshape(-1)])
    return torch.from_numpy(limbs.reshape((16,) + arr.shape).astype(np.int32))


# (batch, windows): every window of a batch together (G = 5, 5, 3), three
# of them (G = 3 at S = 5), and windows alone (G = 1)
SPLITS = [(0, slice(None)), (0, slice(0, 3)), (0, [0]), (0, [2]), (0, [4]),
          (1, slice(None)), (2, slice(None)), (2, [1]), (2, [2])]


@pytest.mark.parametrize("b,windows", SPLITS)
def test_scan_and_boundary_prefix_equal_the_reference(golden, b, windows):
    batch = golden["batches"][b]
    rows, order, key = _inputs(batch, windows)
    totals, table, blk = cuda_point.msm_scan(rows, order, key,
                                             golden["block"], _nb(golden))
    e_pts = msm_sorted._gather_boundary_prefix(
        table, blk, msm_sorted._exclusive_scan_points(totals))
    assert [_words(c) for c in totals] == _golden_points(
        batch["block_totals_mont_words"], windows)
    assert [_words(c) for c in e_pts] == _golden_points(
        batch["e_pts_mont_words"], windows)


def test_window_totals_through_the_scan(golden):
    """window_totals from the scalars: its limbs are the port's Abel sum of
    the reference's boundary prefixes, its points the host's window sums,
    in one group and in groups of two (the last window padded)."""
    batch = golden["batches"][1]
    c, block, bits = golden["c"], golden["block"], golden["max_bits"]
    xy = g1.encode_points([tuple(p) for p in batch["points"]], "cpu")
    scalars = fr("cpu").encode(batch["scalars"])
    W = len(batch["mag"])
    want = msm_sorted._abel_window_totals(
        tuple(_golden_tensor(w) for w in batch["e_pts_mont_words"]),
        _nb(golden))
    for group in (W, 2):
        got = msm_sorted.window_totals(xy[0], xy[1], scalars, bits, group,
                                       block, c)
        assert all(torch.equal(a[:, :W], b) for a, b in zip(got, want))
        assert bool(g1.is_identity(tuple(a[:, W:] for a in got)).all())
    pts = [tuple(p) for p in batch["points"]]
    for w in range(W):
        sd = [(-1 if batch["neg"][w][i] else 1) * batch["mag"][w][i]
              for i in range(len(pts))]
        want_pt = host.msm(pts, [d % host.R for d in sd])
        assert g1.decode_points(g1.to_affine(
            tuple(x[:, w:w + 1] for x in got)))[0] == want_pt


def test_the_stable_sort_gives_the_reference_order(golden):
    for batch in golden["batches"]:
        key = torch.tensor(batch["mag"]) << 1 | torch.tensor(batch["neg"])
        order = torch.sort(key.int(), dim=1, stable=True)[1]
        assert order.tolist() == batch["order"]


def kernel_writes(key, block: int, nb: int):
    """The kernel's write rule, lane by lane as msm_scan_kernel walks:
    writer[g, j] is the sorted position whose running sum lands in slot j
    (-1 where block 0's lane writes the identity, below the window's first
    digit), count[g, j] how many times slot j is written."""
    G, n = key.shape
    S = n // block
    writer = np.full((G, nb), -2)
    count = np.zeros((G, nb), dtype=int)
    for g in range(G):
        for b in range(block):
            if b == 0:
                for j in range(min(key[g, 0] >> 1, nb)):
                    writer[g, j] = -1
                    count[g, j] += 1
            for e in range(b * S, (b + 1) * S):
                k_next = nb << 1 if e + 1 == n else key[g, e + 1]
                for j in range(key[g, e] >> 1, min(k_next >> 1, nb)):
                    writer[g, j] = e
                    count[g, j] += 1
    return writer, count


def _write_rule_cases(golden):
    for batch in golden["batches"]:
        yield _inputs(batch, slice(None))[2].numpy(), golden["block"]
    # wider random windows: sparse digits, a digit missing at the bottom
    rng = np.random.default_rng(9)
    for hi in (3, 9):
        d = np.sort(rng.integers(1, hi, (4, 64)), axis=1)
        yield ((d << 1) | rng.integers(0, 2, (4, 64))).astype(np.int32), 8


def test_kernel_write_rule_matches_bucket_ends(golden):
    nb = _nb(golden)
    for key, block in _write_rule_cases(golden):
        writer, count = kernel_writes(key, block, nb)
        assert (count == 1).all()
        d = key >> 1
        assert writer.tolist() == cuda_point.bucket_ends(
            torch.from_numpy(d), nb).tolist()
        assert writer.tolist() == np.asarray(
            jsorted._bucket_ends(jnp.asarray(d), nb)).tolist()
        # the plain version's blocks follow the same rule
        S = key.shape[1] // block
        rows = torch.zeros((int(key.shape[1]), 16), dtype=torch.int32)
        order = torch.arange(key.shape[1]).repeat(key.shape[0], 1)
        rows[:, 0], rows[:, 8] = 1, 2            # the point (1, 2), packed
        _, _, blk = cuda_point.plain_msm_scan(rows, order,
                                              torch.from_numpy(key), block,
                                              nb)
        assert blk.tolist() == np.where(writer >= 0, writer // S, 0).tolist()


def _digits_at_or_above_nb_cases():
    """(G, n) sorted digits with one at or above nb = 5: the fault's input
    (window 1 of two), the same digit in each window of three in turn, the
    last window, digits far above nb and a whole window above it."""
    cases = [[[0, 1, 6], [0, 1, 2]], [[0, 1, 2], [0, 1, 6]]]
    for g in range(3):
        rows = [[0, 2, 2, 4] for _ in range(3)]
        rows[g] = [0, 2, 4, 5]
        cases.append(rows)
    cases += [[[1, 3, 9, 100], [0, 0, 4, 4]], [[5, 6, 7, 8], [0, 1, 2, 3]],
              [[0, 1, 2, 3], [5, 5, 6, 6]]]
    return cases


@pytest.mark.parametrize("d", _digits_at_or_above_nb_cases())
def test_bucket_ends_drops_digits_at_or_above_nb(d):
    """A digit >= nb falls in no bucket of any window, as the reference's
    truncation and the kernel's clamp have it (the plain version once
    counted it in the next window's histogram, or raised in the last)."""
    nb = 5
    d = np.asarray(d, dtype=np.int32)
    want = np.asarray(jsorted._bucket_ends(jnp.asarray(d), nb)).tolist()
    assert cuda_point.bucket_ends(torch.from_numpy(d), nb).tolist() == want
    # the kernel's write rule on the same sorted digits
    writer, _ = kernel_writes(d << 1, d.shape[1], nb)
    assert writer.tolist() == want


def test_msm_scan_checks_its_operands_and_launches_nothing_here(golden):
    rows, order, key = _inputs(golden["batches"][2], slice(None))
    before = dict(cuda_point.launch_counts)
    with pytest.raises(ValueError):
        cuda_point.msm_scan(rows, order, key, 3, 9)          # n % block
    with pytest.raises(ValueError):
        cuda_point.msm_scan(rows, order.int(), key, 4, 9)    # order dtype
    with pytest.raises(TypeError):
        cuda_point.msm_scan(rows, order, key.long(), 4, 9)   # key dtype
    with pytest.raises(ValueError):
        cuda_point.msm_scan(rows.t(), order, key, 4, 9)      # rows shape
    cuda_point.msm_scan(rows, order, key, 4, 9)
    assert cuda_point.launch_counts == before


def _points(kind):
    rng = random.Random(kind)
    xy = g1.encode_points([host.random_point(rng) for _ in range(3)], "cpu")
    p = g1.from_affine((xy[0], xy[1]))
    F = fq("cpu")
    z = F.encode([5, 7, 11])
    return tuple(F.mul(c, z) for c in p)       # Z != 1


@pytest.mark.parametrize("case", ["P", "P + P", "P + (-P)", "identity"])
def test_level_schedule_equals_the_formulas(case):
    F = fq("cpu")
    p = _points("p")
    ident = g1.identity((3,), "cpu")
    q = {"P": _points("q"), "P + P": p, "P + (-P)": g1.neg(p),
         "identity": ident}[case]
    if case == "identity":
        pairs = [(formulas.add_levels(F, ident, p),
                  cuda_point.plain_point("add", ident, p)),
                 (formulas.add_levels(F, p, ident),
                  cuda_point.plain_point("add", p, ident)),
                 (formulas.double_levels(F, ident),
                  cuda_point.plain_point("double", ident))]
    else:
        pairs = [(formulas.add_levels(F, p, q),
                  cuda_point.plain_point("add", p, q)),
                 (formulas.double_levels(F, q),
                  cuda_point.plain_point("double", q))]
    for got, want in pairs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
