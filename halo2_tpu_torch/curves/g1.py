"""BN254 G1 point arithmetic on limb tensors.

Points are *structures of limb arrays*: an affine point is ``(x, y)`` and
a projective point ``(X, Y, Z)``, each coordinate a ``(16, *batch)`` int32
Montgomery-form Fq limb tensor (see fields/limbs.py).  All group ops are
branch-free **complete formulas** (Renes-Costello-Batina 2015, homogeneous
projective, a = 0), so they run over the batch axis with no data-dependent
control flow: one thread per point in the kernels of curves/cuda_point.py,
which `add`, `add_mixed`, `double`, `horner`, `scalar_mul` and
`fixed_base_mul` go through.

Identity (group zero) in homogeneous projective coordinates is (0 : 1 : 0).
The device is that of the operands; constructors take it explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from halo2_tpu_torch.curves import cuda_point, host
from halo2_tpu_torch.fields.bn254 import fq
from halo2_tpu_torch.fields.limbs import (N_LIMBS, eq, is_zero, to_numpy,
                                          to_tensor)
from halo2_tpu_torch.utils import profiling


def identity(batch_shape, device):
    """(0 : 1 : 0) at batch_shape."""
    F = fq(device)
    zero = F.zeros(batch_shape)
    return (zero, F.ones(batch_shape), zero.clone())


def generator(device):
    """The canonical generator (1, 2) as Montgomery affine limbs."""
    F = fq(device)
    return (F.encode_scalar(1), F.encode_scalar(2))


def from_affine(p_aff):
    """(x, y) affine -> (X, Y, Z) projective with Z = 1."""
    x, y = p_aff
    return (x, y, fq(x.device).ones(x.shape[1:]))


def neg(p):
    """Negate a projective (or affine, 2-tuple) point."""
    F = fq(p[0].device)
    if len(p) == 2:
        x, y = p
        return (x, F.neg(y))
    x, y, z = p
    return (x, F.neg(y), z)


def add(p, q):
    """Complete projective addition (RCB15 Algorithm 7, a=0, b3=9):
    identity, doubling and inverse inputs are handled uniformly."""
    return cuda_point.point_op("add", list(p) + list(q))


def add_mixed(p, q_aff):
    """Complete mixed addition (RCB15 Algorithm 8): projective p + affine
    q.  Complete except when q is the group identity — affine inputs here
    (SRS points, bucket feeds) never are."""
    return cuda_point.point_op("add_mixed", list(p) + list(q_aff))


def double(p):
    """Complete doubling (RCB15 Algorithm 9, a=0, b3=9)."""
    return cuda_point.point_op("double", list(p))


def select(mask, p, q):
    """Elementwise point select: mask ? p : q.

    mask: bool (*batch); p, q: same-arity point tuples broadcastable to it."""
    m = mask[None]
    return tuple(torch.where(m, a, b) for a, b in zip(p, q))


def is_identity(p):
    """(*batch,) bool: Z == 0 (projective) or (x, y) == (0, 0) (affine tag)."""
    if len(p) == 3:
        return is_zero(p[2])
    return is_zero(p[0]) & is_zero(p[1])


def to_affine(p):
    """Projective -> affine via batch inversion of Z.

    Identity points map to the affine tag (0, 0) (the reference's
    `CurveAffine::identity()` encoding of x = y = 0)."""
    x, y, z = p
    F = fq(z.device)
    shape = z.shape
    zinv = F.batch_inverse(z.reshape(N_LIMBS, -1)).reshape(shape)
    ax = F.mul(x, zinv)
    ay = F.mul(y, zinv)
    zero_mask = is_zero(z)[None]
    return (torch.where(zero_mask, 0, ax), torch.where(zero_mask, 0, ay))


def horner(totals, c_bits: int, tail_doubles: int = 0):
    """Horner over windows: totals, 3 coords of (16, *lanes, W) ->
    3 coords of (16, *lanes): acc = T[W-1], then for w = W-2 down to 0,
    c_bits doublings and an add of T[w]; then tail_doubles more doublings.
    One kernel launch for CUDA tensors (curves/cuda_point.py), the plain
    version on the CPU; counted as `horner_calls`."""
    profiling.incr("horner_calls")
    if totals[0].device.type == "cuda":
        return cuda_point.horner(totals, c_bits, tail_doubles)
    return plain_horner(totals, c_bits, tail_doubles)


def plain_horner(totals, c_bits: int, tail_doubles: int = 0):
    """`horner`'s plain version, on any device: the loop of plain point
    operations."""
    W = totals[0].shape[-1]
    acc = tuple(t[..., W - 1] for t in totals)
    for w in range(W - 2, -1, -1):
        for _ in range(c_bits):
            acc = cuda_point.plain_point("double", acc)
        acc = cuda_point.plain_point("add", acc,
                                     tuple(t[..., w] for t in totals))
    for _ in range(tail_doubles):
        acc = cuda_point.plain_point("double", acc)
    return acc


def scalar_mul(p_aff, scalars_std):
    """Batched scalar multiplication: k_i * P_i for affine points.

    scalars_std: (16, *batch) limbs in STANDARD form (not Montgomery) — the
    bit pattern is the actual scalar.  Double-and-add over all 256 bits,
    least significant first: one kernel launch for CUDA tensors
    (curves/cuda_point.py), the plain version on the CPU.  SRS setup
    multiplies the generator only and uses `fixed_base_mul`; MSM uses the
    Pippenger path in halo2_tpu_torch.msm."""
    if p_aff[0].device.type == "cuda":
        return cuda_point.scalar_mul(p_aff, scalars_std)
    return plain_scalar_mul(p_aff, scalars_std)


def plain_scalar_mul(p_aff, scalars_std):
    """`scalar_mul`'s plain version, on any device: the ladder as a loop of
    plain point operations."""
    x, y = p_aff
    acc = identity(x.shape[1:], x.device)
    base = from_affine((x.contiguous(), y.contiguous()))
    for j in range(256):
        bit = (scalars_std[j // 16] >> (j % 16)) & 1
        acc = select(bit == 1, cuda_point.plain_point("add", acc, base), acc)
        if j < 255:
            base = cuda_point.plain_point("double", base)
    return acc


# the fixed-base comb of the generator: windows of FB_BITS bits, a row for
# every digit of every window (digit 0's row is zeros and never added)
FB_BITS = 8
FB_WINDOWS = 256 // FB_BITS
FB_DIGITS = 1 << FB_BITS

_FB_TABLES: dict = {}


class FixedBaseTable:
    """d * 2^(8w) * G for the generator G, every window w < 32 and digit
    d < 256, entry w * 256 + d, the d = 0 entries (0, 0), in the one form
    the device's comb reads: on the CPU `xy`, affine Montgomery limbs
    (2, 16, 8192), for the plain version; on a CUDA device `rows`, the
    same points as (8192, 16) packed words (two limbs a word, words 0-7 x,
    8-15 y), for the kernel.  The other attribute is None."""

    def __init__(self, device):
        F = fq(device)
        pts = [(0, 0) if d == 0 else row[d - 1]
               for row in host.fixed_base_affine(host.G1_GEN, FB_BITS)
               for d in range(FB_DIGITS)]
        limbs = np.stack([F.encode_np([p[0] for p in pts]),
                          F.encode_np([p[1] for p in pts])])
        self.xy = self.rows = None
        if torch.device(device).type == "cuda":
            words = limbs[:, 0::2] | (limbs[:, 1::2] << 16)     # (2, 8, N)
            self.rows = to_tensor(np.ascontiguousarray(
                words.reshape(16, -1).T).view(np.int32), device)
        else:
            self.xy = to_tensor(limbs, device)


def fixed_base_table(device) -> FixedBaseTable:
    """The generator's comb table on `device`, built once a process and
    device (8,160 host points, one host inversion); "cuda" and the current
    card's "cuda:i" share one table."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _FB_TABLES:
        _FB_TABLES[device] = FixedBaseTable(device)
    return _FB_TABLES[device]


def fixed_base_mul(scalars_std):
    """k_i * G for the generator G: scalars_std (16, *batch) limbs in
    STANDARD form, any value below 2^256.  The comb over 32 windows of 8
    bits (the reference's fixed-base method, host.fixed_base_mul): one
    kernel launch for CUDA tensors (curves/cuda_point.py), the plain
    version on the CPU.  Returns projective (X, Y, Z).  Used for SRS
    setup, where every point is a multiple of G."""
    table = fixed_base_table(scalars_std.device)
    if scalars_std.device.type == "cuda":
        return cuda_point.fixed_base_mul(table.rows, scalars_std)
    return plain_fixed_base_mul(table.xy, scalars_std)


def plain_fixed_base_mul(table_xy, scalars_std):
    """`fixed_base_mul`'s plain version, on any device: from the identity,
    for each window w, a plain complete mixed add of entry (w, byte w of
    the scalar), kept where the byte is not 0."""
    acc = identity(scalars_std.shape[1:], scalars_std.device)
    for w in range(FB_WINDOWS):
        d = (scalars_std[w // 2].to(torch.int64) >> (8 * (w % 2))) & 0xFF
        q = tuple(c[:, w * FB_DIGITS + d] for c in table_xy)
        acc = select(d != 0, cuda_point.plain_point("add_mixed", acc, q), acc)
    return acc


# -- host <-> device conversion helpers -------------------------------------

def encode_points(points, device):
    """List of host affine points (int x, int y) or None -> (2, 16, N)
    Montgomery limbs on the device; identity encoded as (0, 0)."""
    F = fq(device)
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    return to_tensor(np.stack([F.encode_np(xs), F.encode_np(ys)]), device)


def decode_points(xy):
    """(2, 16, N) Montgomery affine limbs -> list of host points."""
    if isinstance(xy, (tuple, list)):
        xy = torch.stack(list(xy))
    F = fq(xy.device)
    arr = to_numpy(xy)
    xs = F.decode(arr[0])
    ys = F.decode(arr[1])
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def points_from_bytes(blob: bytes, device):
    """Compressed points (32 bytes each: x little-endian, y's parity in
    bit 255; all zero = the identity) -> (2, 16, N) Montgomery affine limbs
    on `device`, identity as (0, 0).  The square roots y = (x^3 + 3)^((q+1)
    /4) are one `pow` launch on the card for all N, not N host `pow`s.
    Raises ValueError on an encoding that `point_from_bytes` refuses
    (x >= q, x^3 + 3 not a square, the sign bit set on x = 0)."""
    F = fq(device)
    raw = np.frombuffer(blob, dtype=np.uint8).reshape(-1, 32).copy()
    sign = raw[:, 31] >> 7
    raw[:, 31] &= 0x7F
    limbs = np.ascontiguousarray(raw.view("<u2").T)       # (16, N) x
    q_limbs = [(F.p >> (16 * i)) & 0xFFFF for i in range(N_LIMBS)]
    below, equal = np.zeros(len(sign), bool), np.ones(len(sign), bool)
    for i in range(N_LIMBS - 1, -1, -1):
        below |= equal & (limbs[i] < q_limbs[i])
        equal &= limbs[i] == q_limbs[i]
    zero = ~limbs.any(axis=0)
    if not below.all() or (zero & (sign == 1)).any():
        raise ValueError("invalid point encoding")
    x = F.to_mont(to_tensor(limbs, device))
    y2 = F.add(F.mul(F.mul(x, x), x), F.encode_scalar(3))
    y = F.pow_static(y2, (F.p + 1) // 4)
    nonzero = torch.from_numpy(~zero).to(device)
    if not bool((eq(F.mul(y, y), y2) | ~nonzero).all()):
        raise ValueError("invalid point encoding")
    odd = (F.from_mont(y)[0] & 1).cpu().numpy() != sign
    y = torch.where(torch.from_numpy(odd).to(device)[None], F.neg(y), y)
    keep = nonzero[None]
    return torch.stack([torch.where(keep, x, 0), torch.where(keep, y, 0)])
