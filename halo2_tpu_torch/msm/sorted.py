"""Sort-based Pippenger bucket accumulation.

  per window:  sort points by digit (device sort) ->
               blocked prefix scan of point additions (one launch of the
               packed mixed-add kernel per scan step, n adds in all — the
               Pippenger optimum) ->
               bucket sums = differences of prefix values at bucket
               boundaries ->
               sum_b b*B_b = M*E_M - sum_{b<M} E_b  (Abel summation)

  windows are processed in groups that share one scan (group * block points
  per launch).  No scatter, no index-dependent writes; any digit
  distribution (including the all-equal degenerate case) is handled.
"""

from __future__ import annotations

import torch

from halo2_tpu_torch.curves import cuda_point, g1
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.fields.limbs import LIMB_BITS

# signed-window configuration: c bits per window, digits recoded into
# [-2^(c-1), 2^(c-1)] so the bucket table holds 2^(c-1)+1 entries (|digit|;
# the sign rides on the point's y).
SIGNED_C_BITS = 11

# device memory the scan of one window group may take (the prefix buffer
# and the sorted point copies cost about 320 bytes a point and window)
GROUP_MEM_BUDGET = 3 << 30


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


def _prefix_scan_group(pk, sg):
    """Prefix sums over sorted points in scan layout.

    pk: (S, 16, G, B) packed affine words; block b covers sorted positions
    [b*S, (b+1)*S), step s adds position b*S+s; sg: (S, G, B) int32 sign
    flags (negate y).  One launch of the packed mixed-add kernel per step
    (unpack + conditional negate + complete mixed add).

    Returns (intra: 3 coords of (16, S, G, B), the running sums after each
    step; block_excl: 3 coords of (16, G, B))."""
    S, _, G, B = pk.shape
    carry = g1.identity((G, B), pk.device)
    steps = []
    for s in range(S):
        carry = cuda_point.add_mixed_packed(carry, pk[s], sg[s])
        steps.append(carry)
    intra = tuple(torch.stack([st[c] for st in steps], dim=1)
                  for c in range(3))
    return intra, _exclusive_scan_points(carry)


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


def _bucket_ends(d, nb: int):
    """ends[g, b] = (# of digits <= b) - 1 — the bucket-boundary positions
    in the sorted order (-1 when the prefix is empty).  A histogram of the
    digits (one bincount over all windows) and a running sum."""
    G = d.shape[0]
    offs = torch.arange(G, device=d.device, dtype=torch.int64)[:, None] * nb
    counts = torch.bincount((d.to(torch.int64) + offs).reshape(-1),
                            minlength=G * nb).reshape(G, nb)
    return torch.cumsum(counts, dim=1) - 1


def _gather_boundary_prefix(intra, excl, ends, block: int, n: int):
    """Prefix point at sorted position e (may be -1 -> identity).

    intra: 3 coords of (16, S, G, B); excl: 3 x (16, G, B); ends: (G, nb)
    int64 positions.  position e -> block b = e // S, step s = e % S;
    prefix[e] = excl[b] + intra[s, b]."""
    S = n // block
    G, nb = ends.shape
    b_idx = torch.clamp(torch.div(ends, S, rounding_mode="floor"),
                        0, block - 1)
    s_idx = torch.clamp(torch.remainder(ends, S), 0, S - 1)
    g_iota = torch.arange(G, device=ends.device)[:, None].expand(G, nb)
    intra_pt = tuple(c[:, s_idx, g_iota, b_idx] for c in intra)
    excl_pt = tuple(c[:, g_iota, b_idx] for c in excl)
    summed = g1.add(intra_pt, excl_pt)
    # positions < 0 mean "empty prefix" -> identity
    ident = g1.identity((G, nb), ends.device)
    return g1.select(ends >= 0, summed, ident)


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
    S = n // block

    scal = fr(device).from_mont(scalars_mont)
    mag, neg = _signed_digits(scal, num_windows, c)   # (W0, n) each
    if w_pad:
        zeros = torch.zeros((w_pad, n), dtype=torch.int32, device=device)
        mag = torch.cat([mag, zeros], dim=0)
        neg = torch.cat([neg, zeros], dim=0)
    packed = pack_xy(px, py)                          # (16, n)

    totals = []
    for g0 in range(0, W, group):
        d = mag[g0:g0 + group]                        # (G, n) magnitudes
        # fold the sign bit into the sort key: the sorted sign flags fall
        # out of the sort.  Order within a bucket is irrelevant (bucket
        # sums commute).
        key_sorted, order = torch.sort((d << 1) | neg[g0:g0 + group], dim=1)
        # permute the INDICES into scan layout before gathering, so the
        # point gather lands directly as (16, S, G, B)
        idx_scan = order.reshape(group, block, S).permute(2, 0, 1)
        pk = packed[:, idx_scan].permute(1, 0, 2, 3).contiguous()
        sg = (key_sorted & 1).reshape(group, block, S).permute(
            2, 0, 1).contiguous()
        intra, excl = _prefix_scan_group(pk, sg)
        ends = _bucket_ends(d, nb)
        e_pts = _gather_boundary_prefix(intra, excl, ends, block, n)
        totals.append(_abel_window_totals(e_pts, nb))  # 3 x (16, G)
    return tuple(torch.cat([t[c] for t in totals], dim=1) for c in range(3))


def auto_group(n: int, num_windows: int) -> int:
    """Windows per shared scan.

    Prefer ONE group of all windows — every sequential round (prefix-scan
    step, ladder level, Abel fold) then runs at num_windows * block points
    a launch, and the round count stops scaling with the window count.  The
    cap is device memory, so the group shrinks for very large n."""
    g_max = max(1, min(num_windows, GROUP_MEM_BUDGET // (320 * max(n, 1))))
    if g_max >= num_windows:
        return num_windows
    # least padding waste among feasible sizes (padded windows are dead work)
    best = (num_windows + 1, -1)
    for g in range(1, g_max + 1):
        pad = (-num_windows) % g
        if (pad, -g) < best:
            best = (pad, -g)
    return -best[1]
