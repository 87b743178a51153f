"""Multi-scalar multiplication (Pippenger) on limb tensors.

Two paths, picked as the JAX package picks them (halo2_tpu/msm/msm.py):

  * from SORT_BLOCK (2048) points on, the sort-based signed window path of
    msm/sorted.py (sort by digit, blocked prefix scan of point additions,
    bucket sums from prefix differences, Abel summation);
  * below it, on the card, the bucket path: unsigned 8-bit windows
    (C_BITS), every window's 256 buckets filled and reduced to the
    window's total by one kernel launch for all columns
    (`cuda_point.msm_bucket`).  On the CPU the default stays the sorted
    path (the JAX package takes exact host arithmetic there, which the
    port does not carry); `force_scatter=True` takes the bucket path on
    any device, the CPU one through the kernel's plain version.

Either way one Horner combine over the windows follows (one kernel launch
on the card).

  * `max_bits` reproduces the reference's bounded-window fast path
    (`commit_lagrange_with_bound`): scalars known to be short (u16 blinding
    rows) only generate ceil(max_bits/c) windows.

Identity caveat: affine input points must not be the group identity (true
for all SRS commit paths). Zero scalars are fine (digit-0 buckets are
discarded).
"""

from __future__ import annotations

import itertools

import torch

from halo2_tpu_torch.curves import cuda_point, g1
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.fields.limbs import N_LIMBS
from halo2_tpu_torch.msm import sorted as msm_sorted
from halo2_tpu_torch.utils import profiling

SORT_BLOCK = 2048
# the bucket path's window: 16-bit limbs split evenly into 2 digits
C_BITS = 8
MAX_WINDOWS = 32


def _digits(scalars_std, num_windows: int):
    """(16, n) standard-form limbs -> (W, n) int32 byte digits (c = 8)."""
    return torch.stack([(scalars_std[w // 2] >> (8 * (w % 2))) & 0xFF
                        for w in range(num_windows)]).to(torch.int32)


def _pick_lanes(n: int) -> int:
    """The JAX package's lane count: the largest of 64, 32, ..., 1 that
    divides n."""
    for lanes in (64, 32, 16, 8, 4, 2):
        if n % lanes == 0:
            return lanes
    return 1


def bucket_windows(max_bits: int) -> int:
    """Windows of the bucket path for scalars below 2^max_bits."""
    return min((max_bits + C_BITS - 1) // C_BITS, MAX_WINDOWS)


def _combine_windows(totals, c_bits: int):
    """Horner over windows: acc = (acc * 2^c) + T_w, w descending.
    totals: 3 coords of (16, *lanes, W); returns 3 coords of (16, *lanes)
    (`g1.horner`: one kernel launch on the card)."""
    return g1.horner(totals, c_bits)


def _block_for(n: int) -> int:
    """Scan block: SORT_BLOCK, or for a smaller n the power of two at or
    above it (the whole input is then one round of the scan)."""
    if n >= SORT_BLOCK:
        return SORT_BLOCK
    return 1 << max(n - 1, 0).bit_length()


def window_bits_for(block: int) -> int:
    """Signed window width c.  The per-window cost outside the scan (bucket
    boundaries, Abel folds) grows with 2^(c-1) whatever n is, so an input
    of fewer than SORT_BLOCK points takes c = log2(block), as Pippenger's
    c ~ log n asks, and never less than 4; from SORT_BLOCK points on, c is
    SIGNED_C_BITS."""
    if block >= SORT_BLOCK:
        return msm_sorted.SIGNED_C_BITS
    return max(4, block.bit_length() - 1)


def msm_many(points, scalar_columns, max_bits=None, lanes=None,
             force_scatter: bool = False):
    """Several MSMs over the same points: scalar_columns is a list of
    (16, n) Montgomery Fr columns, max_bits a list of per-column bounds on
    the scalars' bit length (default: full scalars).  Returns projective
    (X, Y, Z) limbs, each (16, C).

    Every column gets its own window totals (a short column has fewer
    windows: the reference's bounded-window fast path,
    `commit_lagrange_with_bound`); the totals are padded with the identity
    to one window count and ONE Horner pass combines all the columns, so
    its c * W sequential doublings are paid once, not per column.

    CUDA tensors of fewer than SORT_BLOCK points, and any tensors with
    `force_scatter`, take the bucket path (`lanes`: see `_bucket_totals`);
    the rest take the sorted path, where n is padded up to a multiple of
    the scan block with copies of the first point under zero scalars."""
    px, py = points
    n = px.shape[1]
    if n == 0:
        raise ValueError("msm of no points")
    if not scalar_columns:
        raise ValueError("msm_many needs at least one column")
    bits = list(max_bits) if max_bits is not None \
        else [256] * len(scalar_columns)
    if len(bits) != len(scalar_columns):
        raise ValueError("one max_bits entry per column")
    if force_scatter or (px.device.type == "cuda" and n < SORT_BLOCK):
        return _combine_windows(
            _bucket_totals(px, py, scalar_columns, bits, lanes), C_BITS)
    block = _block_for(n)
    return _combine_windows(
        column_totals(px, py, scalar_columns, bits, block),
        window_bits_for(block))


def column_totals(px, py, scalar_columns, bits, block: int):
    """The window totals of each column over one set of points (16, n):
    3 coords of (16, C, W), every column's totals padded with the identity
    to one window count W.  The points and scalars are padded up to a
    multiple of `block` with copies of the first point under zero
    scalars; the window width and groups follow from `block` and n, so
    equal input sizes give equal windows (the sharded MSM adds the
    totals of its shards)."""
    n = px.shape[1]
    pad = (-n) % block
    if pad:
        px = torch.cat([px, px[:, :1].expand(N_LIMBS, pad)], dim=1)
        py = torch.cat([py, py[:, :1].expand(N_LIMBS, pad)], dim=1)
    c = window_bits_for(block)
    per_column = []
    for scalars_mont, mb in zip(scalar_columns, bits):
        profiling.incr("msm_calls")
        profiling.incr("msm_points", n)
        if pad:
            scalars_mont = torch.nn.functional.pad(scalars_mont, (0, pad))
        num_windows = msm_sorted.num_windows_for(mb, c)
        group = msm_sorted.auto_group(n + pad, num_windows)
        per_column.append(msm_sorted.window_totals(
            px, py, scalars_mont, mb, group, block, c))
    width = max(t[0].shape[1] for t in per_column)
    ident = g1.identity((width,), px.device)
    return tuple(
        torch.stack([torch.cat([t[k], ident[k][:, t[k].shape[1]:]], dim=1)
                     for t in per_column], dim=1)
        for k in range(3))                              # (16, C, W)


def _bucket_totals(px, py, scalar_columns, bits, lanes=None):
    """The bucket path's window totals of each column: 3 coords of (16, C,
    W), W = the most windows of any column, the shorter columns padded
    with the identity.  Digits are the 8-bit windows of the standard-form
    scalars; the rows of all the columns go to ONE `msm_bucket` launch.
    n is padded up to a multiple of `lanes` (default `_pick_lanes(n)`)
    with copies of the first point under zero scalars, as the JAX package
    pads it."""
    n = px.shape[1]
    if lanes is None:
        lanes = _pick_lanes(n)
    pad = (-n) % lanes
    if pad:
        px = torch.cat([px, px[:, :1].expand(N_LIMBS, pad)], dim=1)
        py = torch.cat([py, py[:, :1].expand(N_LIMBS, pad)], dim=1)
    profiling.incr("msm_calls", len(scalar_columns))
    profiling.incr("msm_points", n * len(scalar_columns))
    profiling.incr("msm_bucket_calls")
    std = fr(px.device).from_mont(torch.nn.functional.pad(
        torch.stack(list(scalar_columns), dim=1), (0, pad)))   # (16, C, n)
    widths = [bucket_windows(mb) for mb in bits]
    digits = torch.cat([_digits(std[:, i], w) for i, w in enumerate(widths)])
    totals = cuda_point.msm_bucket(px, py, digits, lanes)
    width = max(widths)
    ident = g1.identity((width,), px.device)
    return tuple(
        torch.stack([torch.cat([t[:, end - w:end], ic[:, w:]], dim=1)
                     for w, end in zip(widths, itertools.accumulate(widths))],
                    dim=1)
        for t, ic in zip(totals, ident))                # (16, C, W)


def msm(points, scalars_mont, max_bits: int = 256, lanes=None,
        force_scatter: bool = False):
    """points: (x, y) each (16, n) Montgomery affine (no identities);
    scalars_mont: (16, n) Montgomery Fr. Returns projective (X, Y, Z) limbs,
    each (16,).  max_bits bounds the scalar bit-length; the default covers
    full scalars.  `lanes` and `force_scatter` are the bucket path's, as
    in `msm_many`."""
    out = msm_many(points, [scalars_mont], [max_bits], lanes=lanes,
                   force_scatter=force_scatter)
    return tuple(c[:, 0] for c in out)


def msm_host_result(points, scalars_mont, **kw):
    """msm + to_affine + decode, for tests and host callers."""
    proj = msm(points, scalars_mont, **kw)
    return g1.decode_points(g1.to_affine(tuple(p[:, None] for p in proj)))[0]
