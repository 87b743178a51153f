"""CUDA kernels for the hot field ops, with a plain PyTorch version of
each beside its wrapper.

Three kernels (csrc/field_kernels.cu over csrc/field.cuh), each taking the
place of one Pallas TPU kernel of halo2_tpu/fields/pallas_ops.py:

  binop      replaces `_binop_call`     — elementwise add / sub / Montgomery
             mul mod p, for Fr and Fq
  butterfly  replaces `_butterfly_call` — radix-2 DIF butterfly
             u = lo + hi, v = (lo - hi) * tw, the twiddle row indexed, never
             broadcast
  mul_tiled  replaces `_mul_tiled_call` — a * t with a table shared by every
             row, indexed j % k

and three that run a chain inside the kernel, where the JAX package
compiles a `lax.scan` (halo2_tpu/fields/limbs.py):

  pow_static  `Field.pow_static`: a static exponent as a sliding-window
              schedule made here (`pow_schedule`), one launch (the square
              roots of a params file's points)
  inv         `Field.inv`: the inverse by safegcd (Bernstein-Yang
              divsteps in libsecp256k1's 32-bit form), one launch; it
              stands for the reference's pow_static(p - 2)
  prefix_mul  `Field.prefix_mul`: inclusive prefix products in one launch
              of tiles, one a block, chained by a decoupled look-back;
              either direction, any n

Their plain versions are the composed loops that stay in fields/limbs.py.

What bounds them on an H100: a Montgomery product is 264 32-bit
multiply-adds (CIOS: for each of 8 words, two rows of 8 low and 8 high
multiply-adds and one product for m) on 128 bytes read and 64 written.
Against 3.35 TB/s and 64 multiply-adds a clock on each of 132 SMs that is
57 ps of memory traffic and some 16 ps of arithmetic an element, so the
elementwise kernels are bound by device memory: storage keeps one 16-bit
limb per 32-bit word (twice the bytes a packed layout would move) so that
state is shared with the rest of the package as it is.  The design keeps
one element per thread in eight 32-bit registers, the whole CIOS product
on carry chains (no intermediate ever leaves the registers), the modulus
in constant memory, and reads every operand once.  The chains are bound by
the latency of their dependent steps instead.

A wrapper launches its kernel for a CUDA tensor and uses the plain version
only for a tensor on the CPU; the chain wrappers take CUDA tensors only.
`launch_counts` counts launches.

Arrays are `torch.int32`, limbs-leading `(16, *batch)`, one 16-bit limb a
word (see fields/limbs.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from halo2_tpu_torch.utils import build

LIMB_BITS = 16
N_LIMBS = 16
MASK = (1 << LIMB_BITS) - 1

launch_counts = {"binop": 0, "butterfly": 0, "mul_tiled": 0, "pow": 0,
                 "inv": 0, "scan": 0}

_OPS = {"add": 0, "sub": 1, "mul": 2}
_FIELD_IDS = {"Fr": 0, "Fq": 1}


# ---------------------------------------------------------------------------
# Plain PyTorch versions: exact int64 arithmetic on the 16-bit limbs
# ---------------------------------------------------------------------------

def _limb_list(x: int, n: int) -> list:
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(n)]


@functools.lru_cache(maxsize=None)
def _constants(p: int, p_inv_neg: int, device: str) -> dict:
    """Constant tensors of the plain versions for one modulus and device.

    The two products by a constant (m = T * -p^-1 mod 2^256 and m * p) are
    matrix products with the constant's Toeplitz matrix.  They run in
    float64, which is exact here: the entries are below 2^21 and 2^16, so
    a sum of 16 products stays below 2^41."""
    i64 = dict(dtype=torch.int64, device=device)
    p_l = _limb_list(p, N_LIMBS)
    pinv_l = _limb_list(p_inv_neg, N_LIMBS)
    p_t = torch.zeros((2 * N_LIMBS, N_LIMBS), dtype=torch.float64)
    pinv_t = torch.zeros((N_LIMBS, N_LIMBS), dtype=torch.float64)
    for j in range(N_LIMBS):
        for i in range(N_LIMBS):
            p_t[i + j, j] = p_l[i]
            if i + j < N_LIMBS:
                pinv_t[i + j, j] = pinv_l[i]
    return {
        "shifts": torch.arange(2 * N_LIMBS + 1, **i64)[:, None],
        # p and 2^256 - p as 17-limb columns
        "p17": torch.tensor(p_l + [0], **i64)[:, None],
        "negp17": torch.tensor(_limb_list((1 << 256) - p, N_LIMBS) + [0],
                               **i64)[:, None],
        # 2^256 - p placed 16 limbs up, as a 33-limb column
        "negp33": torch.tensor(
            [0] * N_LIMBS + _limb_list((1 << 256) - p, N_LIMBS) + [0],
            **i64)[:, None],
        "p_toeplitz": p_t.to(device),
        "pinv_toeplitz": pinv_t.to(device),
    }


def _resolve(acc: torch.Tensor, passes: int, shifts: torch.Tensor):
    """Exact carry normalisation of redundant limbs, modulo 2^(16*width).

    acc: (width, N) int64, every limb in [0, 2^62); it is overwritten.
    Returns (width, N) canonical 16-bit limbs of
    (sum acc_k 2^(16k)) mod 2^(16*width).

    `passes` relaxation passes fold multi-bit carries one limb up (the
    caller states how many its bound needs: before the last pass every
    limb is below 2^32, so after it at most 2^17 - 2; with no pass the
    input already is).  Then the remaining 0/1 carries ripple in one
    integer addition per element: with g the limbs that generate a carry
    and p those that propagate one, the carry into every limb is read off
    the bits of ((g|p) + g) ^ (g|p) ^ g.
    """
    width = acc.shape[0]
    shifts = shifts[:width]
    for _ in range(passes):
        hi = acc >> LIMB_BITS
        acc &= MASK
        acc[1:] += hi[:-1]
    lo = acc & MASK
    g = ((acc >> LIMB_BITS) << shifts).sum(0)
    x = g | ((lo == MASK) << shifts).sum(0)
    carry_in = ((x + g) ^ x ^ g) >> shifts         # bit 0: carry into limb
    return (lo + (carry_in & 1)) & MASK


def _side_by_side(x: torch.Tensor, extra: torch.Tensor, width: int):
    """(width, 2N) int64: x in the left half, x + extra in the right half,
    both zero-extended to `width` limbs (extra is a (width, 1) column)."""
    rows, n = x.shape
    both = x.new_zeros((width, 2 * n))
    both[:rows, :n] = x
    both[:rows, n:] = x
    both[:, n:] += extra
    return both


def _mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(16, N) x (16, N) -> (32, N) redundant limbs of the full product,
    every limb below 2^36.  The 16 x 16 partial products are laid out
    skewed (row i shifted i limbs up) by padding each row to 33 and
    re-reading the buffer 32 wide, then summed over rows."""
    n = a.shape[1]
    prod = a.new_zeros((N_LIMBS, 2 * N_LIMBS + 1, n))
    torch.mul(a[:, None, :], b[None, :, :], out=prod[:, :N_LIMBS, :])
    skew = prod.reshape(N_LIMBS * (2 * N_LIMBS + 1), n)[:2 * N_LIMBS * N_LIMBS]
    return skew.reshape(N_LIMBS, 2 * N_LIMBS, n).sum(0)


def plain_binop(op: str, field, a: torch.Tensor, b: torch.Tensor):
    """add / sub / Montgomery mul mod field.p on (16, N) int32 limb arrays.

    Every op ends in a choice between x and x -/+ p.  Both candidates are
    carried side by side through one carry normalisation, and the carry
    out of the 256 bits says which one is in range."""
    n = a.shape[1]
    c = _constants(field.p, field.p_inv_neg, str(a.device))
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    if op == "add":
        # s = a + b and s + (2^256 - p): the latter overflows iff s >= p
        both = _resolve(_side_by_side(a64 + b64, c["negp17"], N_LIMBS + 1),
                        1, c["shifts"])
        out = torch.where(both[N_LIMBS:, n:] == 1, both[:N_LIMBS, n:],
                          both[:N_LIMBS, :n])
    elif op == "sub":
        # d = a + ~b + 1 = a - b + 2^256 and d + p: d overflows iff a >= b
        d = a64 + (MASK - b64)
        d[0] += 1
        both = _resolve(_side_by_side(d, c["p17"], N_LIMBS + 1), 1,
                        c["shifts"])
        out = torch.where(both[N_LIMBS:, :n] == 1, both[:N_LIMBS, :n],
                          both[:N_LIMBS, n:])
    elif op == "mul":
        t = _mul_wide(a64, b64)                              # T = a * b
        t_lo = t[:N_LIMBS]
        t_lo = (t_lo & MASK).to(torch.float64)
        t_hi1 = (t[:N_LIMBS - 1] >> LIMB_BITS).to(torch.float64)
        t_lo[1:] += t_hi1                  # T mod 2^256, limbs below 2^21
        m = (c["pinv_toeplitz"] @ t_lo).to(torch.int64)      # T * -p^-1
        m = _resolve(m, 2, c["shifts"])                      # mod 2^256
        mp = (c["p_toeplitz"] @ m.to(torch.float64)).to(torch.int64)
        # (T + m p) / R and the same minus p, carried through together
        both = _resolve(_side_by_side(t + mp, c["negp33"], 2 * N_LIMBS + 1),
                        2, c["shifts"])
        out = torch.where(both[2 * N_LIMBS:, n:] == 1,
                          both[N_LIMBS:2 * N_LIMBS, n:],
                          both[N_LIMBS:2 * N_LIMBS, :n])
    else:
        raise ValueError(f"unknown field op {op!r}")
    return out.to(torch.int32)


def plain_butterfly(field, lo, hi, tw, rep: int = 1):
    """lo, hi: (16, mid, half); tw: (16, half // rep), each twiddle serving
    `rep` neighbouring columns.  Returns (16, mid, 2, half): [u, v]."""
    mid, half = lo.shape[1], lo.shape[2]
    twf = tw.repeat_interleave(rep, dim=1) if rep > 1 else tw
    lo2 = lo.reshape(N_LIMBS, mid * half)
    hi2 = hi.reshape(N_LIMBS, mid * half)
    twf = twf[:, None, :].expand(N_LIMBS, mid, half).reshape(
        N_LIMBS, mid * half)
    u = plain_binop("add", field, lo2, hi2)
    v = plain_binop("mul", field, plain_binop("sub", field, lo2, hi2), twf)
    return torch.stack([u.reshape(N_LIMBS, mid, half),
                        v.reshape(N_LIMBS, mid, half)], dim=2)


def plain_mul_tiled(field, a, t):
    """a: (16, mid, k), t: (16, k) -> a * t, t shared by every row."""
    mid, k = a.shape[1], a.shape[2]
    tt = t[:, None, :].expand(N_LIMBS, mid, k).reshape(N_LIMBS, mid * k)
    return plain_binop("mul", field, a.reshape(N_LIMBS, mid * k),
                       tt).reshape(a.shape)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_limbs(name: str, x: torch.Tensor, device=None):
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 limbs, got {x.dtype}")
    if x.ndim < 1 or x.shape[0] != N_LIMBS:
        raise ValueError(f"{name}: expected (16, ...) limbs, got "
                         f"{tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("field_kernels")
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.h2_field_binop.argtypes = [ci, ci, vp, ll, ll, vp, ll, ll, vp, ll,
                                   vp]
    lib.h2_butterfly.argtypes = [ci, vp, vp, ll, ll, vp, ll, ll, vp, ll, ll,
                                 vp]
    lib.h2_mul_tiled.argtypes = [ci, vp, vp, vp, ll, ll, vp]
    lib.h2_field_pow.argtypes = [ci, vp, ll, ll, vp, ll,
                                 ctypes.POINTER(ctypes.c_uint16), ci, ci, ci,
                                 vp]
    lib.h2_field_occupancy.argtypes = [ci, ctypes.POINTER(ci)]
    lib.h2_field_inv.argtypes = [ci, vp, ll, ll, vp, ll,
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.c_uint32,
                                 ctypes.POINTER(ctypes.c_uint32), ci, vp]
    lib.h2_scan.argtypes = [ci, ci, vp, ll, ll, vp, ll, ll, ll, vp, ll, vp]
    for fn in (lib.h2_field_binop, lib.h2_butterfly, lib.h2_mul_tiled,
               lib.h2_field_pow, lib.h2_field_occupancy, lib.h2_field_inv,
               lib.h2_scan):
        fn.restype = ci
    return lib


def _rows(x: torch.Tensor, shape: tuple, n: int):
    """x, of `shape` or one element, as (tensor, limb stride, element
    stride) of n elements, without a copy; None where that takes one."""
    if x.numel() == N_LIMBS:
        return x, x.stride(0), 0
    if tuple(x.shape) != shape:
        return None
    if x.ndim == 2:
        return x, x.stride(0), x.stride(1)
    if x.is_contiguous():
        return x, n, 1
    return None


def _broadcast(a: torch.Tensor, b: torch.Tensor):
    """The batch shape two operands broadcast to (an operand with fewer
    dims is extended on the right, so a (16,) scalar meets any batch),
    the operands reshaped to that many dims, and the element count."""
    nd = max(a.ndim, b.ndim)
    if a.ndim != nd:
        a = a.reshape(tuple(a.shape) + (1,) * (nd - a.ndim))
    if b.ndim != nd:
        b = b.reshape(tuple(b.shape) + (1,) * (nd - b.ndim))
    if any(x != y and 1 not in (x, y) for x, y in zip(a.shape, b.shape)):
        raise ValueError(f"binop: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not broadcast")
    shape = tuple(x if y == 1 else y for x, y in zip(a.shape, b.shape))
    n = 1
    for d in shape[1:]:
        n *= d
    return a, b, shape, n


def plain_op(op: str, field, a: torch.Tensor, b: torch.Tensor):
    """`binop`'s plain version on any device: add / sub / mul of two
    operands that broadcast as binop's do."""
    a, b, shape, n = _broadcast(a, b)
    a2 = a.expand(shape).reshape(N_LIMBS, n)
    b2 = b.expand(shape).reshape(N_LIMBS, n)
    return plain_binop(op, field, a2, b2).reshape(shape)


def binop(op: str, field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field binary op on (16, *batch) limb arrays, broadcasting the batch
    dims as `plain_op` does.  The kernel reads each operand through a limb
    stride and an element stride, so a single element, any (16, n) view
    (a strided column included) and a contiguous array go in as they are;
    any other broadcast is materialised first."""
    if op not in _OPS:
        raise ValueError(f"unknown field op {op!r}")
    dev = a.device
    _check_limbs("binop a", a)
    _check_limbs("binop b", b, dev)
    if dev.type == "cpu":
        return plain_op(op, field, a, b)
    if dev.type != "cuda":
        raise ValueError(f"binop: unsupported device {dev}")
    # the common cases skip the general broadcast: equal shapes, or one
    # operand a single element with no more dims than the other
    if a.shape == b.shape or (b.numel() == N_LIMBS and b.ndim <= a.ndim):
        shape, n = tuple(a.shape), a.numel() // N_LIMBS
    elif a.numel() == N_LIMBS and a.ndim <= b.ndim:
        shape, n = tuple(b.shape), b.numel() // N_LIMBS
    else:
        a, b, shape, n = _broadcast(a, b)
    ra = _rows(a, shape, n) or (
        a.expand(shape).reshape(N_LIMBS, n).contiguous(), n, 1)
    rb = _rows(b, shape, n) or (
        b.expand(shape).reshape(N_LIMBS, n).contiguous(), n, 1)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if n:
        build.launch(dev, _lib().h2_field_binop, _OPS[op],
                     _FIELD_IDS[field.name], ra[0].data_ptr(), ra[1], ra[2],
                     rb[0].data_ptr(), rb[1], rb[2], out.data_ptr(), n)
        launch_counts["binop"] += 1
    return out


# the pow kernel's odd powers: windows of at most POW_WINDOW_MAX bits
# (2^(w-1) odd powers, 32 bytes each, in the thread's column of shared
# memory), at most POW_MAX_STEPS steps (csrc/field_kernels.cu)
POW_WINDOW_MAX = 4
POW_MAX_STEPS = 256


def _windows(e: int, w: int):
    """The sliding windows of e, most significant first: [(value, start
    bit)], each value odd and below 2^w, its lowest bit at `start`."""
    out, i = [], e.bit_length() - 1
    while i >= 0:
        if not (e >> i) & 1:
            i -= 1
            continue
        lo = max(i - w + 1, 0)
        while not (e >> lo) & 1:
            lo += 1
        out.append(((e >> lo) & ((1 << (i - lo + 1)) - 1), lo))
        i = lo - 1
    return out


def pow_schedule(e: int) -> dict:
    """The pow kernel's plan for x^e, e in [0, 2^256): the window width w
    (1 to POW_WINDOW_MAX) that takes the fewest products, the odd powers
    x, x^3, ..., x^(2 entries - 1) it builds (`entries` = 2^(w-1)), the odd
    power r starts from (`first`, an index into them; -1 for e = 0, where
    r = 1), and `words`, the steps as the kernel reads them: r squared
    (word >> 4) times, then multiplied by odd power (word & 15) - 1 where
    (word & 15) is not 0.  `products` counts every Montgomery product, the
    odd powers' included: `squarings` of them (mont_sqr, x^2 and the
    steps') and `multiplies` (mont_mul)."""
    if not 0 <= e < 1 << 256:
        raise ValueError("pow_static: the exponent must lie in [0, 2^256)")
    if e == 0:
        return {"window": 1, "entries": 1, "first": -1, "words": [],
                "products": 0, "squarings": 0, "multiplies": 0}
    best = None
    for w in range(1, POW_WINDOW_MAX + 1):
        wins = _windows(e, w)
        words = [((prev_lo - lo) << 4) | ((val >> 1) + 1)
                 for (_, prev_lo), (val, lo) in zip(wins, wins[1:])]
        if wins[-1][1]:
            words.append(wins[-1][1] << 4)
        entries = 1 << (w - 1)
        sqr = (w > 1) + sum(x >> 4 for x in words)
        mul = entries - 1 + sum(bool(x & 15) for x in words)
        if best is None or sqr + mul < best["products"]:
            best = {"window": w, "entries": entries,
                    "first": wins[0][0] >> 1, "words": words,
                    "products": sqr + mul, "squarings": sqr,
                    "multiplies": mul}
    return best


def _one_a_thread(name: str, a: torch.Tensor):
    """What a kernel of one element a thread (pow, inv) takes: a as
    (tensor, limb stride, element stride), without a copy where `_rows`
    allows, its element count and the output; CUDA tensors only."""
    _check_limbs(f"{name} a", a)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, not "
                         f"{a.device}")
    n = a.numel() // N_LIMBS
    x = _rows(a, tuple(a.shape), n) or (
        a.reshape(N_LIMBS, n).contiguous(), n, 1)
    return x, n, torch.empty(a.shape, dtype=torch.int32, device=a.device)


def pow_static(field, a: torch.Tensor, e: int) -> torch.Tensor:
    """a**e (Montgomery form in and out) for a CUDA tensor (16, *batch), in
    one launch of `pow_schedule(e)`; 0 -> 0 for e > 0, and e = 0 gives one
    everywhere.  The plain version is `Field.plain_pow_static`: both give
    the canonical value."""
    x, n, out = _one_a_thread("pow_static", a)
    plan = pow_schedule(e)
    words = plan["words"]
    if n:
        build.launch(a.device, _lib().h2_field_pow, _FIELD_IDS[field.name],
                     x[0].data_ptr(), x[1], x[2], out.data_ptr(), n,
                     (ctypes.c_uint16 * max(len(words), 1))(*words),
                     len(words), plan["first"], plan["entries"])
        launch_counts["pow"] += 1
    return out


def occupancy() -> dict:
    """Resident blocks a multiprocessor holds of the pow kernel, by field,
    from the CUDA occupancy calculator."""
    out = {}
    for which, name in enumerate(_FIELD_IDS):
        blocks = ctypes.c_int(0)
        err = _lib().h2_field_occupancy(which, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy of pow/{name}: CUDA error {err}")
        out[f"pow/{name}"] = blocks.value
    return out


# safegcd: signed 30-bit limbs, 30 divsteps a batch.  Bernstein and Yang,
# "Fast constant-time gcd computation and modular inversion" (2019),
# Theorem 11.2: from delta = 1, floor((49d + 57) / 17) divsteps reach
# g = 0 when f^2 + 4g^2 <= 5 * 2^(2d) and d >= 46.  f = p and 0 <= g < p
# are below 2^254 for both BN254 fields, so d = 254 and 735 divsteps
# suffice: 25 batches of 30 (750).
INV_LIMB_BITS = 30
INV_LIMBS = 9
INV_DIVSTEPS = 30
INV_BATCHES = 25


@functools.lru_cache(maxsize=None)
def inv_constants(p: int, R: int) -> dict:
    """What the inverse kernel takes for the modulus p (R = 2^256 mod p):
    p in nine 30-bit limbs, p^-1 mod 2^30, R^3 mod p as eight 32-bit
    words (the divsteps invert x = a R into a^-1 R^-1; one Montgomery
    product by R^3 gives a^-1 R), and the batch count."""
    mask = (1 << INV_LIMB_BITS) - 1
    r3 = pow(R, 3, p)
    return {"p30": [(p >> (INV_LIMB_BITS * i)) & mask
                    for i in range(INV_LIMBS)],
            "pinv30": pow(p, -1, 1 << INV_LIMB_BITS),
            "r3": [(r3 >> (32 * k)) & 0xFFFFFFFF for k in range(8)],
            "batches": INV_BATCHES}


def inv(field, a: torch.Tensor) -> torch.Tensor:
    """a^-1 (Montgomery form in and out, 0 -> 0) for a CUDA tensor
    (16, *batch), in one launch.  The plain version is
    `Field.plain_pow_static(a, p - 2)`: the same function, and both give
    the canonical value."""
    x, n, out = _one_a_thread("inv", a)
    c = inv_constants(field.p, field.R)
    if n:
        build.launch(a.device, _lib().h2_field_inv, _FIELD_IDS[field.name],
                     x[0].data_ptr(), x[1], x[2], out.data_ptr(), n,
                     (ctypes.c_int32 * INV_LIMBS)(*c["p30"]), c["pinv30"],
                     (ctypes.c_uint32 * 8)(*c["r3"]), c["batches"])
        launch_counts["inv"] += 1
    return out


# the scan's tiles: SCAN_BLOCK threads a block (csrc/field_kernels.cu), a
# run of V consecutive elements a thread; V is the largest of
# SCAN_PER_THREAD that still leaves SCAN_MIN_TILES tiles (about one for
# each of an H100's 132 SMs), else 1: the fastest V on the card at 2^16,
# 2^18, 5 * 2^16 and 2^22 (examples/torch_chain_probe.py, PERF.md)
SCAN_BLOCK = 256
SCAN_PER_THREAD = (1, 2, 4, 8)
SCAN_MIN_TILES = 128


def scan_plan(n: int):
    """(V, tiles) for a scan of n >= 1 elements: tiles of SCAN_BLOCK * V
    consecutive elements (the last one holds the rest), one block each,
    in one launch."""
    if n < 1:
        raise ValueError("scan_plan: n must be at least 1")
    V = max(v for v in SCAN_PER_THREAD
            if v == 1 or n >= SCAN_MIN_TILES * SCAN_BLOCK * v)
    return V, -(-n // (SCAN_BLOCK * V))


def scan_origin(n: int, es: int, reverse: bool):
    """Where logical element 0 of a scan sits, in elements from the first
    one, and the element stride from one logical element to the next: a
    reverse scan starts at the last element and walks back."""
    return ((n - 1) * es, -es) if reverse else (0, es)


def prefix_mul(field, a: torch.Tensor, reverse: bool = False):
    """Inclusive prefix products of a CUDA (16, n) array, from the end if
    `reverse`, in one launch (`scan_plan`'s tiles); a strided view goes in
    as it is.  The plain version is `Field.plain_prefix_mul`."""
    _check_limbs("prefix_mul a", a)
    if a.ndim != 2:
        raise ValueError("prefix_mul expects (16, N)")
    if a.device.type != "cuda":
        raise ValueError(f"prefix_mul: the kernel takes CUDA tensors, not "
                         f"{a.device}")
    n = a.shape[1]
    out = torch.empty((N_LIMBS, n), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    V, tiles = scan_plan(n)
    dev = a.device
    a0, a_es = scan_origin(n, a.stride(1), reverse)
    o0, o_es = scan_origin(n, 1, reverse)
    # each tile's aggregate and inclusive prefix (8 words each) and flag,
    # and the ticket counter
    state = torch.empty(17 * tiles + 1, dtype=torch.int32, device=dev)
    build.launch(dev, _lib().h2_scan, _FIELD_IDS[field.name], V,
                 a.data_ptr() + 4 * a0, a.stride(0), a_es,
                 out.data_ptr() + 4 * o0, n, o_es, n, state.data_ptr(),
                 tiles)
    launch_counts["scan"] += 1
    return out


def butterfly(field, lo: torch.Tensor, hi: torch.Tensor, tw: torch.Tensor,
              rep: int = 1) -> torch.Tensor:
    """Radix-2 DIF butterfly.  lo, hi: (16, mid, half) — the two halves of
    the rows of one (16, mid, 2, half) array, or any two arrays with equal
    strides and unit stride along `half`; tw: (16, half // rep) contiguous.
    Returns a contiguous (16, mid, 2, half) array whose [:, :, 0] is
    u = lo + hi and [:, :, 1] is v = (lo - hi) * tw[(j % half) // rep]."""
    _check_limbs("butterfly lo", lo)
    _check_limbs("butterfly hi", hi, lo.device)
    _check_limbs("butterfly tw", tw, lo.device)
    if lo.ndim != 3 or hi.shape != lo.shape:
        raise ValueError("butterfly: lo and hi must both be (16, mid, half)")
    mid, half = lo.shape[1], lo.shape[2]
    if rep < 1 or half % rep or tuple(tw.shape) != (N_LIMBS, half // rep):
        raise ValueError(
            f"butterfly: tw must be (16, {half}//{rep}), got "
            f"{tuple(tw.shape)}")
    if lo.device.type == "cpu":
        return plain_butterfly(field, lo, hi, tw, rep)
    if lo.device.type != "cuda":
        raise ValueError(f"butterfly: unsupported device {lo.device}")
    if lo.stride() != hi.stride() or (half > 1 and lo.stride(2) != 1):
        raise ValueError("butterfly: lo and hi need equal strides and unit "
                         "stride along the last axis")
    if not tw.is_contiguous():
        raise ValueError("butterfly: tw must be contiguous")
    out = torch.empty((N_LIMBS, mid, 2, half), dtype=torch.int32,
                      device=lo.device)
    build.launch(lo.device, _lib().h2_butterfly, _FIELD_IDS[field.name],
                 lo.data_ptr(), hi.data_ptr(), lo.stride(0), lo.stride(1),
                 tw.data_ptr(), half // rep, rep, out.data_ptr(), mid, half)
    launch_counts["butterfly"] += 1
    return out


def mul_tiled(field, a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a: (16, *mid, k) times a table t: (16, k) shared by every row (never
    materialised at a's size).  Returns a's shape."""
    _check_limbs("mul_tiled a", a)
    _check_limbs("mul_tiled t", t, a.device)
    if a.ndim < 2 or t.ndim != 2 or t.shape[1] != a.shape[-1]:
        raise ValueError(f"mul_tiled: a {tuple(a.shape)} and t "
                         f"{tuple(t.shape)} do not match")
    k = a.shape[-1]
    mid = a.numel() // (N_LIMBS * k) if k else 0
    if a.device.type == "cpu":
        return plain_mul_tiled(field, a.reshape(N_LIMBS, mid, k),
                               t).reshape(a.shape)
    if a.device.type != "cuda":
        raise ValueError(f"mul_tiled: unsupported device {a.device}")
    if not a.is_contiguous() or not t.is_contiguous():
        raise ValueError("mul_tiled: a and t must be contiguous")
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    build.launch(a.device, _lib().h2_mul_tiled, _FIELD_IDS[field.name],
                 a.data_ptr(), t.data_ptr(), out.data_ptr(), mid, k)
    launch_counts["mul_tiled"] += 1
    return out
