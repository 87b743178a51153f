"""An exact m-point DFT over Fr as two matrix products on the tensor cores.

The m-point DFT over Fr is linear over the input's bytes:

    out_i = sum_{j, li} x_j[li] * (w^{ij} * 2^{8 li} mod p),

so it is one constant matrix of shape (m*32, m*32) against a (m*32, B)
matrix of bytes.  Splitting the matrix's bytes into nibbles (<= 15) makes
both operands exact in bf16, and every float32 sum of K = m*32 products
<= 15*255 stays an exact integer while K <= 4388.  The two nibble products
(`dft_products`) go to the tensor cores; the epilogue (`dft_epilogue`,
kernel K6 in csrc/dft_kernels.cu) turns the float32 byte-basis sums into 17
16-bit limbs, a value below 2^271 congruent mod p to the DFT output.

This is the library half of the reference's examples/mxu_dft_probe.py; its
script is examples/torch_mxu_dft_probe.py.  Arrays are limbs-leading
`torch.int32` as in fields/limbs.py: input (16, m, B), output (17, m, B),
the transform along m, B transforms side by side.

`dft_epilogue` launches its kernel for a CUDA tensor and runs its plain
version (`plain_dft_epilogue`) only for a tensor on the CPU.
`launch_counts` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from halo2_tpu_torch.fields.bn254 import FR_MODULUS, FR_ROOT_OF_UNITY, FR_S
from halo2_tpu_torch.fields.limbs import (LIMB_BITS, MASK, N_LIMBS,
                                          ints_to_limbs_np)
from halo2_tpu_torch.utils import build
from halo2_tpu_torch.utils.device import require_device

P = FR_MODULUS
NB = 32              # bytes of an element: rows of lo / hi per output element
OUT_LIMBS = N_LIMBS + 1
MAX_K = 4388         # largest contraction whose float32 sums stay exact

launch_counts = {"dft_epilogue": 0}


def dft_matrices(m: int, device="cuda", nb_in: int = NB):
    """Nibble-split mod-fold DFT matrices on `device`.

    M[i*32 + lo, j*nb_in + li] = byte lo of (w^{ij} * 2^{8 li} mod p).
    Returns (M_lo, M_hi, w): two bf16 (m*32, m*nb_in) matrices with entries
    <= 15 (M = M_lo + 16 M_hi) and the primitive m-th root of unity w."""
    dev = require_device(device)
    if m < 2 or m & (m - 1):
        raise ValueError(f"m must be a power of two >= 2, got {m}")
    if m * nb_in > MAX_K:
        raise ValueError(f"m * nb_in = {m * nb_in} > {MAX_K}: the float32 "
                         f"sums of the products would not be exact")
    w = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - m.bit_length() + 1), P)
    assert pow(w, m, P) == 1 and pow(w, m // 2, P) != 1
    # w^{ij} depends on ij mod m only: m * nb_in distinct column values
    vals = [pow(w, e, P) * (1 << (8 * li)) % P
            for e in range(m) for li in range(nb_in)]
    cols = np.frombuffer(b"".join(v.to_bytes(NB, "little") for v in vals),
                         np.uint8).reshape(m, nb_in, NB)
    e = np.outer(np.arange(m), np.arange(m)) % m                # (i, j)
    M = cols[e].transpose(0, 3, 1, 2).reshape(m * NB, m * nb_in)
    return (torch.from_numpy((M & 0xF).astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16),
            torch.from_numpy((M >> 4).astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16), w)


@functools.lru_cache(maxsize=None)
def fold_table(extra: int = 4) -> np.ndarray:
    """(16, extra) uint32 limbs of 2^(16*(16+k)) mod p for k < extra
    (read-only)."""
    tab = np.stack([ints_to_limbs_np([pow(2, 16 * (16 + k), P)])[:, 0]
                    for k in range(extra)], axis=1)
    tab.setflags(write=False)
    return tab


def bytes_from_limbs(x: torch.Tensor) -> torch.Tensor:
    """(16, m, B) 16-bit limbs -> (m, 32, B) bytes, byte 2k + h of an
    element being half h of its limb k."""
    b = torch.stack([x & 0xFF, (x >> 8) & 0xFF], dim=1)        # (16, 2, m, B)
    return b.reshape(NB, x.shape[1], x.shape[2]).transpose(0, 1)


def dft_products(M_lo: torch.Tensor, M_hi: torch.Tensor, xk: torch.Tensor):
    """The two nibble products M_lo @ xk and M_hi @ xk as float32.

    On the card: bf16 operands (exact: nibbles and bytes are small
    integers) with float32 output, `torch.mm(..., out_dtype=torch.float32)`,
    so the tensor cores sum in float32 and nothing is rounded to bf16.  On
    the CPU: a float32 product, exact for these integers.  Either way every
    sum is an integer below 2^24, exact whatever the order of summation."""
    if xk.device.type == "cuda":
        a = xk.to(torch.bfloat16)
        return tuple(torch.mm(M.to(torch.bfloat16), a,
                              out_dtype=torch.float32)
                     for M in (M_lo, M_hi))
    a = xk.to(torch.float32)
    return tuple(torch.mm(M.to(torch.float32), a) for M in (M_lo, M_hi))


# ---------------------------------------------------------------------------
# Kernel K6: the epilogue, and its plain version
# ---------------------------------------------------------------------------

def _ripple(acc: torch.Tensor) -> torch.Tensor:
    """Canonical 16-bit limbs of sum acc_k 2^(16k) (int64 limbs >= 0), the
    carry rippled limb by limb; the carry out of the top limb is dropped."""
    out = torch.empty_like(acc)
    c = torch.zeros_like(acc[0])
    for k in range(acc.shape[0]):
        t = acc[k] + c
        out[k] = t & MASK
        c = t >> LIMB_BITS
    return out


def plain_dft_epilogue(lo: torch.Tensor, hi: torch.Tensor,
                       m: int) -> torch.Tensor:
    """lo, hi: (m*32, B) float32 byte-basis sums -> (17, m, B) int32 limbs,
    in int64 tensor ops: the arithmetic of kernel K6 step by step."""
    B = lo.shape[1]
    r = torch.round(lo).to(torch.int64) + (torch.round(hi).to(torch.int64)
                                           << 4)
    r = r.reshape(m, NB, B).transpose(0, 1)                     # (32, m, B)
    acc = r.new_zeros((N_LIMBS + 2, m, B))
    acc[:N_LIMBS] = r[0::2] + ((r[1::2] & 0xFF) << 8)
    acc[1:N_LIMBS + 1] += r[1::2] >> 8
    lmb = _ripple(acc)                                          # (18, m, B)
    tab = torch.from_numpy(fold_table()[:, :2].astype(np.int64)).to(
        lo.device)
    f0 = lmb[N_LIMBS][None] * tab[:, 0, None, None]             # < 2^32
    f1 = lmb[N_LIMBS + 1][None] * tab[:, 1, None, None]
    acc2 = lmb.new_zeros((OUT_LIMBS, m, B))
    acc2[:N_LIMBS] = lmb[:N_LIMBS] + (f0 & MASK) + (f1 & MASK)
    acc2[1:] += (f0 >> LIMB_BITS) + (f1 >> LIMB_BITS)
    return _ripple(acc2).to(torch.int32)


def _lib():
    lib = build.load("dft_kernels")
    if not getattr(lib, "_h2_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.h2_dft_epilogue.argtypes = [vp, vp, vp, ll, ll, vp]
        lib.h2_dft_epilogue.restype = ctypes.c_int
        lib._h2_typed = True
    return lib


def dft_epilogue(lo: torch.Tensor, hi: torch.Tensor, m: int) -> torch.Tensor:
    """lo, hi: (m*32, B) float32 sums of the two nibble products -> (17, m,
    B) int32 limbs of a value below 2^271, congruent mod p to the DFT
    output (kernel K6)."""
    for name, t in (("lo", lo), ("hi", hi)):
        if t.dtype != torch.float32:
            raise TypeError(f"dft_epilogue {name}: expected float32, got "
                            f"{t.dtype}")
        if t.ndim != 2 or t.shape[0] != m * NB:
            raise ValueError(f"dft_epilogue {name}: expected ({m * NB}, B), "
                             f"got {tuple(t.shape)}")
    if hi.shape != lo.shape or hi.device != lo.device:
        raise ValueError("dft_epilogue: lo and hi differ in shape or device")
    if lo.device.type == "cpu":
        return plain_dft_epilogue(lo, hi, m)
    if lo.device.type != "cuda":
        raise ValueError(f"dft_epilogue: unsupported device {lo.device}")
    if not (lo.is_contiguous() and hi.is_contiguous()):
        raise ValueError("dft_epilogue: lo and hi must be contiguous")
    B = lo.shape[1]
    out = torch.empty((OUT_LIMBS, m, B), dtype=torch.int32, device=lo.device)
    with torch.cuda.device(lo.device):
        err = _lib().h2_dft_epilogue(
            lo.data_ptr(), hi.data_ptr(), out.data_ptr(), m, B,
            torch.cuda.current_stream(lo.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dft_epilogue: CUDA launch failed with error "
                           f"{err}")
    launch_counts["dft_epilogue"] += 1
    return out


# ---------------------------------------------------------------------------
# The transform, and its host reference
# ---------------------------------------------------------------------------

def dft_matmul(x: torch.Tensor, M_lo: torch.Tensor, M_hi: torch.Tensor,
               m: int) -> torch.Tensor:
    """m-point DFT of x: (16, m, B) int32 limbs (values below 2^256) along
    m, with the matrices of `dft_matrices(m)`.  Returns (17, m, B) int32
    limbs of a value below 2^271, congruent mod p to the DFT output; a
    chained stage would read them as 34 bytes (nb_in = 34)."""
    if x.dtype != torch.int32 or x.ndim != 3 or x.shape[0] != N_LIMBS \
            or x.shape[1] != m:
        raise ValueError(f"dft_matmul: expected (16, {m}, B) int32 limbs, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if M_lo.device != x.device or M_hi.device != x.device:
        raise ValueError("dft_matmul: matrices and input on different "
                         "devices")
    xk = bytes_from_limbs(x).reshape(m * NB, x.shape[2])
    lo, hi = dft_products(M_lo, M_hi, xk)
    return dft_epilogue(lo, hi, m)


def host_dft(xs, w: int, m: int) -> list:
    """O(m^2) DFT of the Python ints xs over Fr: the exact reference."""
    out = []
    for i in range(m):
        acc = 0
        for j in range(m):
            acc = (acc + pow(w, i * j, P) * xs[j]) % P
        out.append(acc)
    return out
