"""CUDA kernels for G1 point operations, with a plain PyTorch version of
each beside its wrapper.

Two kernels (csrc/point_kernels.cu over csrc/point.cuh), each taking the
place of one Pallas TPU kernel of halo2_tpu/curves/pallas_point.py:

  point_op          replaces `_point_call` — one complete projective G1
                    operation on Fq: add (6 coordinates in), add_mixed (5),
                    double (3) -> X, Y, Z
  add_mixed_packed  replaces `_add_mixed_packed_call` — the MSM scan step:
                    unpack a packed affine point (two limbs a word, rows 0-7
                    x, rows 8-15 y), negate y where the sign is set, complete
                    mixed add onto the carry

and three that run a chain of point operations in one launch, where the
JAX package compiles it into one `lax.scan`:

  msm_scan     the MSM's bucket scan of one window group (msm/sorted.py
               `window_totals`): every scan step of `_add_mixed_packed_call`
               with the running sums in registers, writing the block totals
               and the bucket-boundary prefixes
  horner       `g1.horner`: the MSM's combine over windows (msm/msm.py
               `_combine_windows`) and the Abel sum's M * E_M doublings
               (msm/sorted.py), a group of 8 threads a lane
  scalar_mul   the double-and-add ladder of `g1.scalar_mul`
  fixed_base_mul  `g1.fixed_base_mul`: k * G for the generator G by a comb
               of 32 windows of 8 bits over a table of 8,160 points (the
               SRS setup's point multiplications)
  msm_bucket   the MSM's bucket path below 2048 points (msm/msm.py): the
               buckets of 8-bit digits and their reduction to each
               window's total, where the JAX package runs a `lax.scan` of
               lane-private bucket adds and log-depth reductions

Their plain versions are `plain_msm_scan` (the steps as a loop of
`plain_add_mixed_packed`), `plain_msm_bucket` (the JAX package's
lane-private buckets, lane merge and suffix-scan reduction) and the
composed loops `g1.plain_horner`, `g1.plain_scalar_mul` and
`g1.plain_fixed_base_mul`, on `plain_point`.

What bounds them on an H100: an add is 12 Montgomery products of 264
integer multiply-adds and some 29 additions on 576 bytes (six coordinates
read, three written).  Against 3.35 TB/s and 64 multiply-adds a clock on
each of 132 SMs that is 172 ps of memory traffic and some 190 ps of
arithmetic a point: about even, so occupancy decides.  One point per
thread, all intermediates in registers (three 256-bit coordinates in, about
a dozen live values); the field product is one non-inlined function with
its operands in registers (csrc/point.cuh), which sets the registers, the
stack and so the resident blocks.  The scan is as bound by operations as
an add.  The Horner chain is bound by the latency of its dependent point
operations: a group of threads runs each operation's products side by
side.

A wrapper launches its kernel for CUDA tensors and uses the plain version
only for tensors on the CPU; `horner`, `scalar_mul` and `fixed_base_mul`
take CUDA tensors only.
`launch_counts` counts launches.

The plain versions follow curves/formulas.py operation for operation, but
run independent field operations of one formula as ONE stacked call (an
extra leading axis), and take 3x and 9x as products by a constant: on
narrow batches the cost of a plain field op is all per-call overhead.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields.bn254 import fq
from halo2_tpu_torch.utils import build

N_LIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

launch_counts = {"point_op": 0, "add_mixed_packed": 0, "msm_scan": 0,
                 "horner": 0, "ladder": 0, "fixed_base": 0, "msm_bucket": 0}

# buckets of a window of the bucket path (8-bit digits), and the points
# msm_bucket_kernel sorts at a time (csrc/point_kernels.cu)
BUCKETS = 256
BUCKET_CHUNK = 2048

_N_IN = {"add": 6, "add_mixed": 5, "double": 3}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

class _Stacked:
    """Field ops on lists of (16, N) arrays, one plain call per list."""

    def __init__(self, device):
        self.F = fq(device)
        self.three = self.F.encode_scalar(3)
        self.nine = self.F.encode_scalar(9)

    def _run(self, op, xs, ys):
        k, n = len(xs), xs[0].shape[1]
        a = torch.stack(xs, 1).reshape(N_LIMBS, k * n)
        b = torch.stack(ys, 1).reshape(N_LIMBS, k * n)
        out = cuda_ops.plain_binop(op, self.F, a, b).reshape(N_LIMBS, k, n)
        return [out[:, i] for i in range(k)]

    def add(self, xs, ys):
        return self._run("add", xs, ys)

    def sub(self, xs, ys):
        return self._run("sub", xs, ys)

    def mul(self, xs, ys):
        return self._run("mul", xs, ys)

    def const(self, c, like):
        return c.to(like.device)[:, None].expand(N_LIMBS, like.shape[1])


def _tail(S, t0, t1, t2, t3, t4, y3):
    """The common second half of RCB15 algorithms 7 and 8, from
    t0 = x1 x2, t1 = y1 y2, t2 = z1 z2 (or z1), t3, t4, y3."""
    nine, three = S.const(S.nine, t0), S.const(S.three, t0)
    t2, y3, t0 = S.mul([t2, y3, t0], [nine, nine, three])
    (z3,) = S.add([t1], [t2])
    (t1,) = S.sub([t1], [t2])
    xa, xb, ya, yb, za, zb = S.mul([t4, t3, y3, t1, t0, z3],
                                   [y3, t1, t0, z3, t3, t4])
    (x3,) = S.sub([xb], [xa])
    y3, z3 = S.add([yb, zb], [ya, za])
    return (x3, y3, z3)


def _plain_add(S, p, q):
    x1, y1, z1 = p
    x2, y2, z2 = q
    s1, s2, s3, s4, s5, s6 = S.add([x1, x2, y1, y2, x1, x2],
                                   [y1, y2, z1, z2, z1, z2])
    t0, t1, t2, m3, m4, m5 = S.mul([x1, y1, z1, s1, s3, s5],
                                   [x2, y2, z2, s2, s4, s6])
    a1, a2, a3 = S.add([t0, t1, t0], [t1, t2, t2])
    t3, t4, y3 = S.sub([m3, m4, m5], [a1, a2, a3])
    return _tail(S, t0, t1, t2, t3, t4, y3)


def _plain_add_mixed(S, p, q_aff):
    x1, y1, z1 = p
    x2, y2 = q_aff
    s1, s2 = S.add([x2, x1], [y2, y1])
    t0, t1, m3, m4, m5 = S.mul([x1, y1, s1, y2, x2], [x2, y2, s2, z1, z1])
    a1, t4, y3 = S.add([t0, m4, m5], [t1, y1, x1])
    (t3,) = S.sub([m3], [a1])
    return _tail(S, t0, t1, z1, t3, t4, y3)


def _plain_double(S, p):
    x, y, z = p
    t0, t1, t2, xy = S.mul([y, y, z, x], [y, z, z, y])
    nine = S.const(S.nine, t0)
    eight = S.const(S.F.encode_scalar(8), t0)
    three = S.const(S.three, t0)
    z3, t2 = S.mul([t0, t2], [eight, nine])
    (t2x3,) = S.mul([t2], [three])
    (y3,) = S.add([t0], [t2])
    (t0,) = S.sub([t0], [t2x3])
    x3, z3, y3, xx = S.mul([t2, t1, t0, t0], [z3, z3, y3, xy])
    y3, x3 = S.add([x3, xx], [y3, xx])
    return (x3, y3, z3)


_PLAIN = {"add": _plain_add, "add_mixed": _plain_add_mixed,
          "double": _plain_double}


def plain_point_op(op: str, coords):
    """coords: flat list of (16, N) coordinate arrays. Returns (X, Y, Z)."""
    S = _Stacked(coords[0].device)
    coords = [c.contiguous() for c in coords]
    if op == "double":
        return _PLAIN[op](S, tuple(coords))
    return _PLAIN[op](S, tuple(coords[:3]), tuple(coords[3:]))


def plain_point(op: str, *points):
    """plain_point_op on point tuples of any one batch shape (16, *B):
    add (p, q), add_mixed (p, q_affine) or double (p)."""
    shape = points[0][0].shape
    flat = [c.reshape(N_LIMBS, -1) for p in points for c in p]
    return tuple(o.reshape(shape) for o in plain_point_op(op, flat))


def unpack_xy(packed: torch.Tensor):
    """(16, N) packed words (two 16-bit limbs a word: rows 0-7 x, rows
    8-15 y; all 32 bits in use) -> ((16, N) x, (16, N) y)."""
    def unpack(c):  # (8, N) -> (16, N)
        lo = c & MASK
        hi = (c >> LIMB_BITS) & MASK      # mask: >> on int32 keeps the sign
        return torch.stack([lo, hi], dim=1).reshape((-1,) + c.shape[1:])
    return unpack(packed[:8]), unpack(packed[8:])


def plain_add_mixed_packed(carry, packed_xy, sign):
    """carry: (X, Y, Z) (16, N); packed_xy: (16, N); sign: (N,) 0/1."""
    F = fq(packed_xy.device)
    qx, qy = unpack_xy(packed_xy)
    qy = torch.where(sign[None] != 0, F.neg(qy), qy)
    return plain_point_op("add_mixed", list(carry) + [qx, qy])


def bucket_ends(d, nb: int):
    """ends[g, j] = (# of digits <= j in row g) - 1: in a row sorted by
    digit, the last position whose digit is <= j (-1 when there is none).
    d: (G, n) digits, in any order; a digit at or above nb falls in no
    bucket (as `msm_scan_kernel` writes no slot for it).  A histogram of
    the digits (one bincount over all rows, each row with a spare slot nb
    that takes such digits and is cut off) and a running sum."""
    G = d.shape[0]
    offs = torch.arange(G, device=d.device,
                        dtype=torch.int64)[:, None] * (nb + 1)
    counts = torch.bincount(
        (d.to(torch.int64).clamp(max=nb) + offs).reshape(-1),
        minlength=G * (nb + 1)).reshape(G, nb + 1)[:, :nb]
    return torch.cumsum(counts, dim=1) - 1


def plain_msm_scan(rows, order, key, block: int, nb: int):
    """`msm_scan`'s plain version: the S = n / block scan steps as a loop
    of `plain_add_mixed_packed` at width G * block (the scan layout: lane
    (g, b) adds sorted position b*S + s at step s), then the running sums
    at the bucket ends picked by `bucket_ends`."""
    G, n = key.shape
    S = n // block
    F = fq(rows.device)
    idx = order.reshape(G, block, S).permute(2, 0, 1)         # (S, G, B)
    pk = rows[idx].permute(0, 3, 1, 2).reshape(S, N_LIMBS, G * block)
    sg = (key & 1).reshape(G, block, S).permute(2, 0, 1).reshape(S, -1)
    zero = F.zeros((G * block,))
    carry = (zero, F.ones((G * block,)), zero)
    steps = []
    for s in range(S):
        carry = plain_add_mixed_packed(carry, pk[s], sg[s])
        steps.append(carry)
    totals = tuple(c.reshape(N_LIMBS, G, block) for c in carry)
    ends = bucket_ends(key >> 1, nb)                          # (G, nb)
    found = ends >= 0
    e = ends.clamp(min=0)
    b_idx = torch.div(e, S, rounding_mode="floor")
    lane = torch.arange(G, device=key.device)[:, None] * block + b_idx
    ident = (F.zeros((G, nb)), F.ones((G, nb)), F.zeros((G, nb)))
    table = tuple(
        torch.where(found[None],
                    torch.stack([st[c] for st in steps])[e % S, :, lane]
                    .permute(2, 0, 1), ic)
        for c, ic in zip(range(3), ident))
    blk = torch.where(found, b_idx, 0).to(torch.int32)
    return totals, table, blk


def _plain_identity(F, shape):
    zero = F.zeros(shape)
    return (zero, F.ones(shape), zero.clone())


def _plain_sum_last(pts):
    """Sum points along the last axis by a halving tree of plain adds (an
    odd length keeps its last point for the next level)."""
    L = pts[0].shape[-1]
    while L > 1:
        h = L // 2
        s = plain_point("add", tuple(c[..., :h] for c in pts),
                        tuple(c[..., h:2 * h] for c in pts))
        pts = tuple(torch.cat([a, c[..., 2 * h:]], dim=-1)
                    for a, c in zip(s, pts))
        L = pts[0].shape[-1]
    return tuple(c[..., 0] for c in pts)


def plain_msm_bucket(px, py, digits, lanes: int):
    """`msm_bucket`'s plain version, the JAX package's algorithm
    (halo2_tpu/msm/msm.py `_accumulate`, `_merge_lanes`,
    `_reduce_buckets`): point i goes to lane i % lanes, every (row, lane)
    owns a column of 256 buckets, and the n / lanes steps each add one
    point a lane into the bucket of its digit (bucket 0 included); then
    the lanes are merged by a tree of adds, and each row's buckets are
    reduced by a Hillis-Steele suffix scan S_b = sum_{j >= b} B_j and a
    tree sum of S_1 .. S_255.  Returns 3 coordinates of (16, rows)."""
    R, n = digits.shape
    L = lanes
    F = fq(px.device)
    buckets = _plain_identity(F, (R, BUCKETS, L))
    r_idx = torch.arange(R, device=px.device)[:, None]
    l_idx = torch.arange(L, device=px.device)[None, :]
    pxr = px.reshape(N_LIMBS, n // L, L)
    pyr = py.reshape(N_LIMBS, n // L, L)
    dr = digits.to(torch.int64).reshape(R, n // L, L)
    for s in range(n // L):
        d = dr[:, s, :]                                   # (R, L)
        cur = tuple(c[:, r_idx, d, l_idx] for c in buckets)
        aff = tuple(c[:, s, :][:, None, :].expand(N_LIMBS, R, L)
                    for c in (pxr, pyr))
        new = plain_point("add_mixed", cur, aff)
        for c, v in zip(buckets, new):
            c[:, r_idx, d, l_idx] = v
    merged = _plain_sum_last(buckets)                     # (16, R, 256)
    s = 1
    while s < BUCKETS:
        shifted = tuple(torch.cat([c[..., s:], ic], dim=-1) for c, ic
                        in zip(merged, _plain_identity(F, (R, s))))
        merged = plain_point("add", merged, shifted)
        s *= 2
    merged = tuple(torch.cat([ic, c[..., 1:]], dim=-1) for c, ic
                   in zip(merged, _plain_identity(F, (R, 1))))
    return _plain_sum_last(merged)


def _radix_pairs(half: int, d_in: int):
    """The operand slots (u, w) of a radix round's 2 * half adds, as
    msm_bucket_kernel's `radix_pair` picks them: item i < half pairs row
    sums (2i, 2i + 1), item half + q the column sums 16 apart from d_in."""
    i = np.arange(half)
    u = np.concatenate([2 * i, d_in + 32 * (i >> 4) + (i & 15)])
    w = np.concatenate([2 * i + 1, d_in + 32 * (i >> 4) + (i & 15) + 16])
    return u, w


def _with_bit(k, j):
    return ((k >> j) << (j + 1)) | (1 << j) | (k & ((1 << j) - 1))


def bucket_threads(rows: int, sms: int) -> int:
    """The block size h2_msm_bucket launches msm_bucket_kernel with for
    `rows` rows on a card of `sms` multiprocessors: 256 threads where the
    rows fit the SMs one a SM, else 128 (two blocks a SM)."""
    return BUCKETS // 2 if rows > sms else BUCKETS


def _bucket_row_ops(row: np.ndarray, ops: dict, T: int) -> None:
    """Adds to `ops` the point operations msm_bucket_kernel makes on one
    row of digits in a block of T threads, walking its schedule on
    presence flags (an add whose operand is the identity is skipped, and
    not counted)."""
    NB = BUCKETS
    t = np.arange(T)
    S = np.zeros(NB, dtype=bool)                  # the buckets' slots
    for c0 in range(0, len(row), BUCKET_CHUNK):
        dd = row[c0:c0 + BUCKET_CHUNK] & (NB - 1)
        lst = np.sort(dd[dd != 0])                 # the sorted list's digits
        M = len(lst)
        start = np.searchsorted(lst, np.arange(NB + 1))
        start[NB] = M
        L = -(-M // T)
        a = np.minimum(t * L, M)
        e = np.minimum(a + L, M)
        full = a < e
        # pieces: a run's positions split where the digit changes
        new = np.ones(M, dtype=bool)
        new[1:] = lst[1:] != lst[:-1]
        new[a[full]] = True
        ops["mixed_adds"] += int(M - new.sum())
        # each bucket is written once a chunk: an add where its slot holds
        # an earlier chunk's sum
        nonempty = np.flatnonzero(start[1:] > start[:-1])
        ops["complete_adds"] += int(S[nonempty].sum())
        S[nonempty] = True
        pb = np.where(full, lst[np.maximum(e - 1, 0)] if M else 0, 0)
        first = np.where((pb > 0) & (start[pb] < a),
                         start[pb] // max(L, 1), t)
        V = full.copy()
        s = 1
        while s < (t - first + 1).max():
            take = t - s >= first
            other = np.zeros(T, dtype=bool)
            other[s:] = V[:-s]
            ops["complete_adds"] += int((take & V & other).sum())
            V = V | (take & other)
            s <<= 1
        # the heads: runs with more than one piece whose first bucket began
        # before them
        first_bucket = np.where(full, lst[np.minimum(a, max(M - 1, 0))]
                                if M else 0, 0)
        head = full & (first_bucket != pb) & (start[first_bucket] < a)
        ops["complete_adds"] += int((head[1:] & V[:-1]).sum())
    # the reduction
    P = S.copy()
    P[0] = False
    for half, d_in in ((128, 0), (64, 128), (32, 64), (16, 32)):
        u, w = _radix_pairs(half, d_in)
        if half == 128:                           # C_0's and D_0's sums
            used = np.concatenate([np.arange(128) >= 8,
                                   np.arange(128) & 15 != 0])
            u, w = u[used], w[used]
            items = np.flatnonzero(used)
        else:
            items = np.arange(2 * half)
        ops["complete_adds"] += int((P[u] & P[w]).sum())
        out = np.zeros(NB, dtype=bool)
        out[items] = P[u] | P[w]
        P = out
    g = np.arange(32)
    plane, p = g >> 2, g & 3
    base = np.where(plane < 4, 16, 0)
    u = base + _with_bit(2 * p, plane & 3)
    w = base + _with_bit(2 * p + 1, plane & 3)
    ops["complete_adds"] += int((P[u] & P[w]).sum())
    P = P[u] | P[w]
    for _ in range(2):                            # 16, then 8 adds
        ops["complete_adds"] += int((P[0::2] & P[1::2]).sum())
        P = P[0::2] | P[1::2]
    for doublings in (1, 2, 4):                   # x + 2^k y
        lo, hi = P[0::2], P[1::2]
        ops["doublings"] += doublings * int(hi.sum())
        ops["complete_adds"] += int((lo & hi).sum())
        P = lo | hi


def msm_bucket_ops(digits, threads: int = BUCKETS) -> dict:
    """The point operations msm_bucket_kernel makes on these digits ((rows,
    n), values in [0, 256)) in blocks of `threads` (bucket_threads): the
    fill's mixed adds (a piece's first point costs none), the complete
    adds of its chains, bucket writes and reduction, and the reduction's
    doublings; an add with the identity is skipped and not counted.  The
    kernel's own count, for a report beside the function's bound;
    computed on the host."""
    d = np.asarray(torch.as_tensor(digits).cpu(), dtype=np.int64)
    ops = {"mixed_adds": 0, "complete_adds": 0, "doublings": 0}
    for row in d.reshape(-1, d.shape[-1]):
        _bucket_row_ops(row, ops, threads)
    return ops


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def typed(lib):
    """Set the argument and result types of the point kernels' entry
    points on a loaded library; returns it."""
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.h2_point_add.argtypes = [vp] * 9 + [ll, vp]
    lib.h2_point_add_mixed.argtypes = [vp] * 8 + [ll, vp]
    lib.h2_point_double.argtypes = [vp] * 6 + [ll, vp]
    lib.h2_add_mixed_packed.argtypes = [vp] * 8 + [ll, vp]
    lib.h2_point_horner.argtypes = [vp] * 3 + [ll] * 4 + [ci] * 3 + \
        [vp] * 4
    lib.h2_point_ladder.argtypes = [vp, vp, ll, ll, vp, ll, ll, vp, vp, vp,
                                    ll, vp]
    lib.h2_msm_scan.argtypes = [vp] * 3 + [ll] + [ci] * 3 + [vp] * 8
    lib.h2_fixed_base.argtypes = [vp, vp, ll, ll, vp, vp, vp, ll, vp]
    lib.h2_msm_bucket.argtypes = [vp, vp, vp, ll, ci, vp, vp, vp, vp]
    lib.h2_point_occupancy.argtypes = [ci, ctypes.POINTER(ci)]
    for fn in (lib.h2_point_add, lib.h2_point_add_mixed, lib.h2_point_double,
               lib.h2_add_mixed_packed, lib.h2_point_horner,
               lib.h2_point_ladder, lib.h2_msm_scan, lib.h2_fixed_base,
               lib.h2_msm_bucket, lib.h2_point_occupancy):
        fn.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return typed(build.load("point_kernels"))


OCCUPANCY_KERNELS = ("add", "add_mixed", "double", "add_mixed_packed",
                     "horner", "ladder", "msm_scan", "fixed_base",
                     "msm_bucket", "msm_bucket_128")


def occupancy(lib=None) -> dict:
    """Resident blocks a multiprocessor holds, per point kernel of `lib`
    (default: the package's build), from the CUDA occupancy calculator:
    blocks of 128 threads, and of 256 and 128 for msm_bucket."""
    lib = lib or _lib()
    out = {}
    for which, name in enumerate(OCCUPANCY_KERNELS):
        blocks = ctypes.c_int(0)
        err = lib.h2_point_occupancy(which, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy of {name}: CUDA error {err}")
        out[name] = blocks.value
    return out


def _check(name: str, x: torch.Tensor, shape, device):
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def _flat(x: torch.Tensor, n: int) -> torch.Tensor:
    """x as (lead, n) contiguous: a contiguous 2-D x as it is, else a
    reshaped (and, if need be, copied) view."""
    if x.dim() == 2 and x.is_contiguous():
        return x
    return x.reshape(x.shape[0], n).contiguous()


def point_op(op: str, coords):
    """One complete G1 operation on every point of a batch.

    coords: flat list of (16, *B) Fq coordinate arrays of one shape —
    add: X1 Y1 Z1 X2 Y2 Z2; add_mixed: X1 Y1 Z1 x2 y2 (the affine point not
    the identity); double: X Y Z.  Returns (X, Y, Z) of that shape."""
    if op not in _N_IN:
        raise ValueError(f"unknown point op {op!r}")
    if len(coords) != _N_IN[op]:
        raise ValueError(f"{op}: expected {_N_IN[op]} coordinate arrays")
    shape, device = coords[0].shape, coords[0].device
    if len(shape) < 1 or shape[0] != N_LIMBS:
        raise ValueError(f"{op}: expected (16, ...) limbs, got {tuple(shape)}")
    for c in coords:
        _check("point_op", c, shape, device)
    n = 1
    for d in shape[1:]:
        n *= d
    flat = [_flat(c, n) for c in coords]
    if device.type == "cpu":
        out = plain_point_op(op, flat)
        return tuple(o.reshape(shape) for o in out)
    if device.type != "cuda":
        raise ValueError(f"point {op}: unsupported device {device}")
    out = tuple(torch.empty(shape, dtype=torch.int32, device=device)
                for _ in range(3))
    build.launch(device, getattr(_lib(), "h2_point_" + op),
                 *[c.data_ptr() for c in flat],
                 *[o.data_ptr() for o in out], n)
    launch_counts["point_op"] += 1
    return out


def add_mixed_packed(carry, packed_xy: torch.Tensor, sign: torch.Tensor):
    """carry: (X, Y, Z), each (16, *B); packed_xy: (16, *B) packed affine
    words (msm.sorted.pack_xy layout, all 32 bits in use); sign: (*B,)
    int32 0/1 — y is negated where it is 1.  Returns (X, Y, Z)."""
    shape, device = packed_xy.shape, packed_xy.device
    if len(shape) < 1 or shape[0] != N_LIMBS:
        raise ValueError("add_mixed_packed: packed_xy must be (16, ...)")
    _check("add_mixed_packed packed_xy", packed_xy, shape, device)
    for c in carry:
        _check("add_mixed_packed carry", c, shape, device)
    _check("add_mixed_packed sign", sign, shape[1:], device)
    n = 1
    for d in shape[1:]:
        n *= d
    flat = [_flat(c, n) for c in carry]
    pk = _flat(packed_xy, n)
    sg = sign if sign.dim() == 1 and sign.is_contiguous() \
        else sign.reshape(n).contiguous()
    if device.type == "cpu":
        out = plain_add_mixed_packed(flat, pk, sg)
        return tuple(o.reshape(shape) for o in out)
    if device.type != "cuda":
        raise ValueError(f"add_mixed_packed: unsupported device {device}")
    out = tuple(torch.empty(shape, dtype=torch.int32, device=device)
                for _ in range(3))
    build.launch(device, _lib().h2_add_mixed_packed,
                 *[c.data_ptr() for c in flat], pk.data_ptr(), sg.data_ptr(),
                 *[o.data_ptr() for o in out], n)
    launch_counts["add_mixed_packed"] += 1
    return out


def msm_scan(rows: torch.Tensor, order: torch.Tensor, key: torch.Tensor,
             block: int, nb: int):
    """The bucket scan of one window group, one launch for CUDA tensors.

    rows: (N, 16) int32, one 64-byte row a point (`pack_xy` words, x then
    y); order: (G, n) int64 point indices below N and key: (G, n) int32
    (digit << 1) | sign, both sorted by key along each window; n a
    multiple of `block`; a digit at or above nb is added into its lane's
    sum but falls in no bucket of the table.  Lane (g, b) adds the sorted
    positions b*S + s, s < S = n / block, in order, from the identity.

    Returns (totals, table, blk): totals, 3 coordinates of (16, G, block),
    each lane's sum; table, 3 coordinates of (16, G, nb), and blk (G, nb)
    int32: for digit j, the running sum at the last position whose digit
    is <= j and the block that holds it (the identity and block 0 where
    no digit is <= j)."""
    device = rows.device
    if rows.dim() != 2 or rows.shape[1] != N_LIMBS:
        raise ValueError(f"msm_scan: rows must be (N, 16), got "
                         f"{tuple(rows.shape)}")
    if key.dim() != 2:
        raise ValueError("msm_scan: key must be (G, n)")
    G, n = key.shape
    if block < 1 or n % block or nb < 1:
        raise ValueError(f"msm_scan: n = {n} is no multiple of block = "
                         f"{block}, or nb = {nb} < 1")
    _check("msm_scan rows", rows, rows.shape, device)
    _check("msm_scan key", key, (G, n), device)
    if order.dtype != torch.int64 or tuple(order.shape) != (G, n) \
            or order.device != device:
        raise ValueError("msm_scan: order must be int64 (G, n) on the "
                         "device of rows")
    if device.type == "cpu":
        return plain_msm_scan(rows, order, key, block, nb)
    if device.type != "cuda":
        raise ValueError(f"msm_scan: unsupported device {device}")
    if not (rows.is_contiguous() and order.is_contiguous()
            and key.is_contiguous()) or rows.data_ptr() % 16:
        raise ValueError("msm_scan: operands must be contiguous, rows "
                         "16-byte aligned")

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)
    totals = tuple(empty(N_LIMBS, G, block) for _ in range(3))
    table = tuple(empty(N_LIMBS, G, nb) for _ in range(3))
    blk = empty(G, nb)
    if G and n:
        build.launch(device, _lib().h2_msm_scan, rows.data_ptr(),
                     order.data_ptr(), key.data_ptr(), n, G, block, nb,
                     *[t.data_ptr() for t in totals],
                     *[t.data_ptr() for t in table], blk.data_ptr())
        launch_counts["msm_scan"] += 1
    return totals, table, blk


def _cuda_only(name: str, device):
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, not "
                         f"{device}")


def horner_shape(shape):
    """(16, *lanes, W) -> (lane count, W) of a Horner combine."""
    if len(shape) < 2 or shape[0] != N_LIMBS or shape[-1] < 1:
        raise ValueError(f"horner: expected (16, *lanes, W) totals, got "
                         f"{tuple(shape)}")
    lanes = 1
    for d in shape[1:-1]:
        lanes *= d
    return lanes, shape[-1]


def horner(totals, c_bits: int, tail_doubles: int = 0):
    """One launch for CUDA tensors: totals, 3 coordinates of (16, *lanes,
    W), -> 3 coordinates of (16, *lanes): acc = T[W-1], then for w = W-2
    down to 0, c_bits complete doublings and a complete add of T[w]; then
    tail_doubles more doublings.  The plain version is g1.plain_horner."""
    shape, device = totals[0].shape, totals[0].device
    _cuda_only("horner", device)
    lanes, W = horner_shape(shape)
    if c_bits < 0 or tail_doubles < 0:
        raise ValueError("horner: c_bits and tail_doubles must be >= 0")
    for c in totals:
        _check("horner totals", c, shape, device)
    # (16, lanes, W) views with one set of strides, copied only if need be
    t3 = [c.reshape(N_LIMBS, lanes, W) for c in totals]
    if any(t.stride() != t3[0].stride() for t in t3):
        t3 = [t.contiguous() for t in t3]
    out = tuple(torch.empty((N_LIMBS,) + tuple(shape[1:-1]),
                            dtype=torch.int32, device=device)
                for _ in range(3))
    if lanes:
        build.launch(device, _lib().h2_point_horner,
                     *[t.data_ptr() for t in t3], *t3[0].stride(), lanes, W,
                     c_bits, tail_doubles, *[o.data_ptr() for o in out])
        launch_counts["horner"] += 1
    return out


def scalar_mul(p_aff, scalars_std: torch.Tensor):
    """One launch for CUDA tensors: k_i * P_i for affine points (x, y),
    each (16, *B), never the identity, and standard-form scalar limbs
    (16, *B).  Returns projective (X, Y, Z).  The plain version is
    g1.plain_scalar_mul."""
    x, y = p_aff
    shape, device = x.shape, x.device
    _cuda_only("scalar_mul", device)
    if len(shape) < 1 or shape[0] != N_LIMBS:
        raise ValueError(f"scalar_mul: expected (16, ...) limbs, got "
                         f"{tuple(shape)}")
    _check("scalar_mul x", x, shape, device)
    _check("scalar_mul y", y, shape, device)
    _check("scalar_mul scalars", scalars_std, shape, device)
    n = x.numel() // N_LIMBS
    x2, y2 = x.reshape(N_LIMBS, n), y.reshape(N_LIMBS, n)
    if x2.stride() != y2.stride():
        x2, y2 = x2.contiguous(), y2.contiguous()
    s2 = scalars_std.reshape(N_LIMBS, n)
    out = tuple(torch.empty(shape, dtype=torch.int32, device=device)
                for _ in range(3))
    if n:
        build.launch(device, _lib().h2_point_ladder, x2.data_ptr(),
                     y2.data_ptr(), *x2.stride(), s2.data_ptr(), *s2.stride(),
                     *[o.data_ptr() for o in out], n)
        launch_counts["ladder"] += 1
    return out


# the comb table's rows: 32 windows of 256 digits
FIXED_BASE_ROWS = 32 * 256


def fixed_base_mul(rows: torch.Tensor, scalars_std: torch.Tensor):
    """One launch for CUDA tensors: k_i * G for standard-form scalar limbs
    (16, *B) and the comb table `rows` of G, (8192, 16) packed words
    (g1.FixedBaseTable).  Returns projective (X, Y, Z) of the scalars'
    shape.  The plain version is g1.plain_fixed_base_mul."""
    shape, device = scalars_std.shape, scalars_std.device
    _cuda_only("fixed_base_mul", device)
    if len(shape) < 1 or shape[0] != N_LIMBS:
        raise ValueError(f"fixed_base_mul: expected (16, ...) limbs, got "
                         f"{tuple(shape)}")
    _check("fixed_base_mul scalars", scalars_std, shape, device)
    _check("fixed_base_mul rows", rows, (FIXED_BASE_ROWS, N_LIMBS), device)
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("fixed_base_mul: rows must be contiguous and "
                         "16-byte aligned")
    n = scalars_std.numel() // N_LIMBS
    s2 = scalars_std.reshape(N_LIMBS, n)
    out = tuple(torch.empty(shape, dtype=torch.int32, device=device)
                for _ in range(3))
    if n:
        build.launch(device, _lib().h2_fixed_base, rows.data_ptr(),
                     s2.data_ptr(), *s2.stride(),
                     *[o.data_ptr() for o in out], n)
        launch_counts["fixed_base"] += 1
    return out


def msm_bucket(px: torch.Tensor, py: torch.Tensor, digits: torch.Tensor,
               lanes: int = 1):
    """Each row's bucket total, one launch for CUDA tensors: for every row
    r of `digits`, sum_i digits[r, i] * P_i.

    px, py: (16, n) affine Montgomery limbs, no point the identity;
    digits: (rows, n) int32 in [0, 256), digit 0 the discarded bucket;
    n a multiple of `lanes`.  Returns projective (X, Y, Z), each (16,
    rows).  `lanes` is the plain version's count of lane-private bucket
    columns (the JAX package's layout); the kernel sorts a row's points
    by digit in one block whatever `lanes` is, so the two give the same
    group element and differ in projective limbs.  The plain version is
    `plain_msm_bucket`."""
    device = px.device
    if px.dim() != 2 or px.shape[0] != N_LIMBS:
        raise ValueError(f"msm_bucket: expected (16, n) limbs, got "
                         f"{tuple(px.shape)}")
    n = px.shape[1]
    if digits.dim() != 2 or digits.shape[1] != n:
        raise ValueError(f"msm_bucket: digits must be (rows, {n}), got "
                         f"{tuple(digits.shape)}")
    if lanes < 1 or n < 1 or n % lanes:
        raise ValueError(f"msm_bucket: n = {n} is no multiple of lanes = "
                         f"{lanes}")
    _check("msm_bucket px", px, (N_LIMBS, n), device)
    _check("msm_bucket py", py, (N_LIMBS, n), device)
    _check("msm_bucket digits", digits, digits.shape, device)
    if device.type == "cpu":
        return plain_msm_bucket(px, py, digits, lanes)
    if device.type != "cuda":
        raise ValueError(f"msm_bucket: unsupported device {device}")
    if n >= 1 << 31:
        raise ValueError("msm_bucket: n must be below 2^31")
    px, py, digits = px.contiguous(), py.contiguous(), digits.contiguous()
    rows = digits.shape[0]
    out = tuple(torch.empty((N_LIMBS, rows), dtype=torch.int32,
                            device=device) for _ in range(3))
    if rows:
        build.launch(device, _lib().h2_msm_bucket, px.data_ptr(),
                     py.data_ptr(), digits.data_ptr(), n, rows,
                     *[o.data_ptr() for o in out])
        launch_counts["msm_bucket"] += 1
    return out
