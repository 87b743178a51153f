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

What bounds them on an H100: an add is 12 Montgomery products and some 29
additions, about 3,700 32-bit integer operations, on 576 bytes (six
coordinates read, three written).  Against 3.35 TB/s and some 33 T integer
operations a second that is 172 ps of memory traffic and 111 ps of
arithmetic a point: bound by device memory, though not by much.  One point
per thread, all intermediates in registers (three 256-bit coordinates in,
about a dozen live values: register pressure decides the occupancy); the
field product is one non-inlined device function so the formulas stay
compact.

A wrapper launches its kernel for CUDA tensors and uses the plain version
only for tensors on the CPU.  `launch_counts` counts launches.

The plain versions follow curves/formulas.py operation for operation, but
run independent field operations of one formula as ONE stacked call (an
extra leading axis), and take 3x and 9x as products by a constant: on
narrow batches the cost of a plain field op is all per-call overhead.
"""

from __future__ import annotations

import ctypes

import torch

from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields.bn254 import fq
from halo2_tpu_torch.utils import build

N_LIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

launch_counts = {"point_op": 0, "add_mixed_packed": 0}

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


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _lib():
    lib = build.load("point_kernels")
    if not getattr(lib, "_h2_typed", False):
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.h2_point_add.argtypes = [vp] * 9 + [ll, vp]
        lib.h2_point_add.restype = ci
        lib.h2_point_add_mixed.argtypes = [vp] * 8 + [ll, vp]
        lib.h2_point_add_mixed.restype = ci
        lib.h2_point_double.argtypes = [vp] * 6 + [ll, vp]
        lib.h2_point_double.restype = ci
        lib.h2_add_mixed_packed.argtypes = [vp] * 8 + [ll, vp]
        lib.h2_add_mixed_packed.restype = ci
        lib._h2_typed = True
    return lib


def _check(name: str, x: torch.Tensor, shape, device):
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def _flat(x: torch.Tensor, n: int) -> torch.Tensor:
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
        _check(f"point {op}", c, shape, device)
    n = 1
    for d in shape[1:]:
        n *= d
    flat = [_flat(c, n) for c in coords]
    if device.type == "cpu":
        out = plain_point_op(op, flat)
        return tuple(o.reshape(shape) for o in out)
    if device.type != "cuda":
        raise ValueError(f"point {op}: unsupported device {device}")
    out = tuple(torch.empty((N_LIMBS, n), dtype=torch.int32, device=device)
                for _ in range(3))
    fn = getattr(_lib(), "h2_point_" + op)
    with torch.cuda.device(device):
        err = fn(*[c.data_ptr() for c in flat],
                 *[o.data_ptr() for o in out], n,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"point {op}: CUDA launch failed with error {err}")
    launch_counts["point_op"] += 1
    return tuple(o.reshape(shape) for o in out)


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
    sg = sign.reshape(n).contiguous()
    if device.type == "cpu":
        out = plain_add_mixed_packed(flat, pk, sg)
        return tuple(o.reshape(shape) for o in out)
    if device.type != "cuda":
        raise ValueError(f"add_mixed_packed: unsupported device {device}")
    out = tuple(torch.empty((N_LIMBS, n), dtype=torch.int32, device=device)
                for _ in range(3))
    with torch.cuda.device(device):
        err = _lib().h2_add_mixed_packed(
            *[c.data_ptr() for c in flat], pk.data_ptr(), sg.data_ptr(),
            *[o.data_ptr() for o in out], n,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"add_mixed_packed: CUDA launch failed with error {err}")
    launch_counts["add_mixed_packed"] += 1
    return tuple(o.reshape(shape) for o in out)
