"""Sort-based Pippenger bucket accumulation.

  per window:  sort points by digit (device sort) ->
               blocked prefix scan of point additions (n adds in all — the
               Pippenger optimum) that writes the prefix at every bucket
               boundary ->
               bucket sums = differences of prefix values at bucket
               boundaries ->
               sum_b b*B_b = M*E_M - sum_{b<M} E_b  (Abel summation)

  windows are processed in groups that share one scan: one launch of the
  scan kernel (`cuda_point.msm_scan`) a group, group * block lanes.  Any
  digit distribution (including the all-equal degenerate case) is handled.
"""

from __future__ import annotations

import os

import torch

from halo2_tpu_torch.curves import cuda_point, g1
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.fields.limbs import LIMB_BITS
from halo2_tpu_torch.utils import profiling

# signed-window configuration: c bits per window, digits recoded into
# [-2^(c-1), 2^(c-1)] so the bucket table holds 2^(c-1)+1 entries (|digit|;
# the sign rides on the point's y).
SIGNED_C_BITS = 11

# device memory the scan of one window group may take (the environment's
# HALO2_TPU_MSM_MEM, in bytes, overrides it, as in the JAX package), and
# what a group holds a point and window at its peak (the sort key, its
# sorted copy and the int64 order, the sort's scratch): 61.7 bytes at 2^18
# points and 30.2 at 2^20 in groups of 24 windows on an H100
# (examples/torch_msm_memory.py)
GROUP_MEM_BUDGET = 3 << 30
GROUP_BYTES_PER_POINT_WINDOW = 64


def _raw_digits_c(scalars_std, num_windows: int, c: int):
    """(16, n) standard 16-bit limbs -> (W, n) int32 unsigned c-bit digits."""
    n_limbs = scalars_std.shape[0]
    parts = []
    for w in range(num_windows):
        off = c * w
        i, sh = off // 16, off % 16
        lo = scalars_std[i] >> sh
        if sh + c > 16 and i + 1 < n_limbs:
            lo = lo | (scalars_std[i + 1] << (16 - sh))
        parts.append(lo & ((1 << c) - 1))
    return torch.stack(parts)


def _signed_digits(scalars_std, num_windows: int, c: int):
    """Signed-window recoding.

    Returns (mag, neg): (W, n) int32 bucket magnitudes in [0, 2^(c-1)] and
    (W, n) int32 0/1 sign flags.  d_w' = d_w + carry; if d' >= 2^(c-1):
    d' -= 2^c, carry = 1.  The top window absorbs the final carry without
    overflow as long as the scalar field leaves >= 2 spare bits there
    (callers size num_windows with `num_windows_for`)."""
    raw = _raw_digits_c(scalars_std, num_windows, c)
    half = 1 << (c - 1)
    full = 1 << c
    mags, negs = [], []
    carry = torch.zeros_like(raw[0])
    for w in range(num_windows):
        d = raw[w] + carry
        if w == num_windows - 1:
            neg = torch.zeros_like(d)
            mag = d
        else:
            neg = (d >= half).to(torch.int32)
            mag = torch.where(neg == 1, full - d, d)
            carry = neg
        mags.append(mag)
        negs.append(neg)
    return torch.stack(mags), torch.stack(negs)


def pack_xy(px, py):
    """Pack affine (x, y) 16-bit limb rows into one (16, n) int32 array,
    two limbs per word (rows 0-7 x, rows 8-15 y).  The per-window point
    gather is random-access traffic: packing halves the gathered bytes and
    folds the two coordinate gathers into one.  The words use all 32 bits;
    the high limb goes in as a signed 16-bit value so that nothing
    overflows int32 on the way."""
    def pack(c):
        hi = c[1::2]
        hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)
        return (hi * (1 << LIMB_BITS)) | c[0::2]             # (8, n)
    return torch.cat([pack(px), pack(py)], dim=0)


def _shift_fill_identity(pts, s):
    """Shift points right by s along the last axis, identity-filling."""
    ident = g1.identity(pts[2].shape[1:-1] + (s,), pts[2].device)
    return tuple(torch.cat([ic, c[..., :-s]], dim=-1)
                 for c, ic in zip(pts, ident))


def _hs_exclusive(totals):
    """Exclusive prefix scan of points along the last axis (length B, a
    power of two): a Hillis-Steele ladder of log2(B) full-width adds."""
    B = totals[0].shape[-1]
    if B == 1:
        return g1.identity(totals[2].shape[1:], totals[2].device)
    x = _shift_fill_identity(totals, 1)   # make it exclusive first
    s = 1
    while s < B:
        x = g1.add(x, _shift_fill_identity(x, s))
        s *= 2
    return x


def _exclusive_scan_points(totals, seq: int = 32):
    """Exclusive prefix scan over the last axis (length B, power of two),
    two-level work-efficient: B = B1 * S2 sub-blocks; S2 sequential adds at
    width B1 give the inclusive prefixes inside every sub-block (work B
    adds a window, against B*log2(B) for a flat ladder), the B1 sub-block
    totals get the ladder, and one full-width add combines."""
    B = totals[0].shape[-1]
    if B <= 2 * seq:
        return _hs_exclusive(totals)
    S2 = seq
    B1 = B // S2
    lead = tuple(totals[0].shape[:-1])          # (16, G)
    r = tuple(c.reshape(lead + (B1, S2)) for c in totals)
    acc = tuple(c[..., 0] for c in r)
    incl = [acc]
    for s in range(1, S2):
        acc = g1.add(acc, tuple(c[..., s] for c in r))
        incl.append(acc)
    ident = g1.identity(lead[1:] + (B1,), totals[0].device)
    excl_intra = tuple(
        torch.stack([ident[c]] + [st[c] for st in incl[:-1]], dim=-1)
        for c in range(3))                      # (16, G, B1, S2)
    blk_excl = _hs_exclusive(acc)               # (16, G, B1)
    out = g1.add(excl_intra, tuple(
        c[..., None].expand(lead + (B1, S2)) for c in blk_excl))
    return tuple(c.reshape(lead + (B,)) for c in out)


def _sum_points_lastaxis(pts):
    """Sum points along the last axis (length M, a power of two) with a
    halving tree: log2(M) launches, M - 1 adds in all."""
    L = pts[0].shape[-1]
    while L > 1:
        h = L // 2
        pts = g1.add(tuple(c[..., :h] for c in pts),
                     tuple(c[..., h:] for c in pts))
        L = h
    return tuple(c[..., 0] for c in pts)


def _gather_boundary_prefix(table, blk, excl):
    """Prefix point at every bucket boundary: E_j = excl[blk_j] + table_j.

    table: 3 coords of (16, G, nb) and blk: (G, nb) int32, the scan's
    running sums at the bucket ends and their blocks (`cuda_point.msm_scan`;
    where no digit is <= j, the identity at block 0, whose exclusive prefix
    is the identity, so E_j is the identity); excl: 3 x (16, G, B), the
    blocks' exclusive prefixes."""
    g_iota = torch.arange(blk.shape[0], device=blk.device)[:, None]
    return g1.add(table, tuple(c[:, g_iota, blk] for c in excl))


def _abel_window_totals(e_pts, nb: int):
    """E points (3 coords of (16, G, nb)) -> per-window totals (16, G) x3.

    total = sum_b b * Bucket_b = M * E_M - sum_{b=0}^{M-1} E_b with
    M = nb - 1 = 2^(c-1) (Abel summation over bucket boundary prefixes)."""
    M = nb - 1
    if M & (M - 1):
        raise ValueError("bucket count must be a power of two plus one")
    s_sum = _sum_points_lastaxis(tuple(c[..., :M] for c in e_pts))
    acc = g1.horner(tuple(c[..., M:] for c in e_pts), 0,   # M * E_M
                    M.bit_length() - 1)
    return g1.add(acc, g1.neg(s_sum))


def num_windows_for(max_bits: int, c: int = SIGNED_C_BITS) -> int:
    """Window count for the signed-c-bit path. Scalars are canonical
    (< 2^254 for BN254 Fr), so 254 caps the useful bit range; the +2 spare
    bits in the top window absorb the signed-recoding carry."""
    bits = min(max_bits, 254)
    w = (bits + c - 1) // c
    # top window must absorb carry without reaching 2^(c-1):
    if bits - c * (w - 1) > c - 2:
        w += 1
    return max(w, 1)


def window_totals(px, py, scalars_mont, max_bits: int, group: int,
                  block: int, c: int = SIGNED_C_BITS):
    """Per-window signed-bucket totals.

    px/py: (16, n) Montgomery affine, n a multiple of `block`;
    scalars_mont: (16, n).  Returns projective totals, 3 coords of (16, W)
    where W = num_windows_for(max_bits, c) padded up to a multiple of
    `group` (padded windows have all-zero digits so their totals are the
    identity — harmless in the Horner combine)."""
    n = px.shape[1]
    device = px.device
    if n % block:
        raise ValueError(f"n = {n} is not a multiple of block = {block}")
    num_windows = num_windows_for(max_bits, c)
    nb = (1 << (c - 1)) + 1
    w_pad = (-num_windows) % group
    W = num_windows + w_pad

    scal = fr(device).from_mont(scalars_mont)
    mag, neg = _signed_digits(scal, num_windows, c)   # (W0, n) each
    if w_pad:
        zeros = torch.zeros((w_pad, n), dtype=torch.int32, device=device)
        mag = torch.cat([mag, zeros], dim=0)
        neg = torch.cat([neg, zeros], dim=0)
    rows = pack_xy(px, py).t().contiguous()           # (n, 16): a row a point

    totals = []
    for g0 in range(0, W, group):
        # fold the sign bit into the sort key: the sorted sign flags fall
        # out of the sort.  The sort is stable, as the reference's, so the
        # additions run in the reference's order.
        key_sorted, order = torch.sort(
            (mag[g0:g0 + group] << 1) | neg[g0:g0 + group], dim=1,
            stable=True)
        profiling.incr("msm_window_groups")
        blk_totals, table, blk = cuda_point.msm_scan(rows, order, key_sorted,
                                                     block, nb)
        e_pts = _gather_boundary_prefix(
            table, blk, _exclusive_scan_points(blk_totals))
        totals.append(_abel_window_totals(e_pts, nb))  # 3 x (16, G)
    return tuple(torch.cat([t[c] for t in totals], dim=1) for c in range(3))


def auto_group(n: int, num_windows: int) -> int:
    """Windows per shared scan.

    Prefer ONE group of all windows — every sequential round (prefix-scan
    step, ladder level, Abel fold) then runs at num_windows * block points
    a launch, and the round count stops scaling with the window count.  The
    cap is device memory, so the group shrinks for very large n."""
    budget = int(os.environ.get("HALO2_TPU_MSM_MEM", GROUP_MEM_BUDGET))
    per_window = GROUP_BYTES_PER_POINT_WINDOW * max(n, 1)
    g_max = max(1, min(num_windows, budget // per_window))
    if g_max >= num_windows:
        return num_windows
    # least padding waste among feasible sizes (padded windows are dead work)
    best = (num_windows + 1, -1)
    for g in range(1, g_max + 1):
        pad = (-num_windows) % g
        if (pad, -g) < best:
            best = (pad, -g)
    return -best[1]
