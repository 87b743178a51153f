"""Multi-limb modular arithmetic over int32 limb tensors.

The bottom layer of the stack: field elements as tensors, the `Field`
context with its constants and ops.

Layout (decided once, here):
  * A field element is ``N_LIMBS = 16`` limbs of ``LIMB_BITS = 16`` bits,
    stored **limbs-leading** as a ``torch.int32`` tensor of shape
    ``(16, *batch)``, one limb per 32-bit word.  These are the same bytes
    as the JAX package's ``uint32`` arrays, so state carries across with a
    view (`torch.uint32` lacks most eager ops).
  * Limbs-leading keeps the batch axis contiguous: thread *i* of a kernel
    reads word ``j*N + i``, which is coalesced; the kernels gather the 16
    words into eight 32-bit registers (csrc/field.cuh).
  * Montgomery representation with ``R = 2**256`` is the form on the
    device, converted at host boundaries.

`add`, `sub` and `mul` go to `fields/cuda_ops.py`, which launches a kernel
for a CUDA tensor and runs its plain version for a CPU tensor; so do
`pow_static`, `inv` and `prefix_mul`, each one kernel launch on the card,
whose plain versions (`plain_pow_static`, `plain_pow_static(a, p - 2)`,
`plain_prefix_mul`) are the composed loops here.  Everything else is composed of those.  The
host conversions `encode_np` and `decode` go through the host codec
(native/); `plain_encode_np` and `plain_decode` are their plain versions.
Canonical 32-byte rows (`decode_le_rows`, `encode_le_bytes_dev`) go up as
they are and are decoded on the card (`cuda_ops.decode_le32`).
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from halo2_tpu_torch import native
from halo2_tpu_torch.fields import cuda_ops

LIMB_BITS = 16
N_LIMBS = 16  # 256 bits total
MASK = (1 << LIMB_BITS) - 1
DTYPE = torch.int32


# ---------------------------------------------------------------------------
# Host-side conversions (numpy / Python ints)
# ---------------------------------------------------------------------------

def int_to_limbs_np(x: int, n_limbs: int = N_LIMBS) -> np.ndarray:
    """Python int -> (n_limbs,) uint32 little-endian 16-bit limbs."""
    out = np.empty((n_limbs,), dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = x & MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit in limbs")
    return out


def ints_to_limbs_np(xs, n_limbs: int = N_LIMBS) -> np.ndarray:
    """Iterable of ints -> (n_limbs, N) uint32 (packed through
    int.to_bytes + frombuffer: one C-level conversion per element)."""
    xs = list(xs)
    nbytes = 2 * n_limbs
    try:
        blob = b"".join(x.to_bytes(nbytes, "little") for x in xs)
    except OverflowError:
        raise ValueError("value does not fit in limbs") from None
    arr = np.frombuffer(blob, dtype="<u2").reshape(len(xs), n_limbs)
    return np.ascontiguousarray(arr.T).astype(np.uint32)


def limbs_to_int(limbs) -> int:
    """(n_limbs,) array -> Python int."""
    limbs = np.asarray(limbs)
    x = 0
    for i in range(limbs.shape[0] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(limbs[i])
    return x


def limbs_to_ints(limbs) -> list:
    """(n_limbs, N) array -> list of N Python ints."""
    arr = np.ascontiguousarray(np.asarray(limbs).astype("<u2").T)
    blob = arr.tobytes()
    step = 2 * arr.shape[1]
    return [int.from_bytes(blob[i:i + step], "little")
            for i in range(0, len(blob), step)]


def to_tensor(limbs_np: np.ndarray, device) -> torch.Tensor:
    """numpy limb array (any integer dtype, values < 2^31) -> int32 tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(limbs_np).astype(np.int32)).to(device)


def to_numpy(limbs: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> numpy uint32 array on the host."""
    return limbs.detach().cpu().numpy().view(np.uint32)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(16, *B) -> bool (*B): all limbs zero."""
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


# ---------------------------------------------------------------------------
# Field context
# ---------------------------------------------------------------------------

class Field:
    """Constants + ops for one prime field, Montgomery form with R = 2**256,
    allocating on one explicit device.

    The same class serves BN254 Fr and Fq (see fields/bn254.py).  Values
    are (16, *batch) int32 tensors in Montgomery form unless a function
    says otherwise.
    """

    def __init__(self, modulus: int, name: str, device):
        self.p = modulus
        self.name = name
        self.device = torch.device(device)
        self.R = (1 << 256) % modulus
        self.R2 = (self.R * self.R) % modulus
        self.R_inv = pow(self.R, modulus - 2, modulus)
        # -p^{-1} mod 2**256 (Montgomery constant)
        self.p_inv_neg = (-pow(modulus, -1, 1 << 256)) % (1 << 256)
        self.num_bits = modulus.bit_length()

        self.p_np = int_to_limbs_np(modulus)
        self.r_np = int_to_limbs_np(self.R)          # one in Montgomery form
        self.r2_np = int_to_limbs_np(self.R2)
        self.one = to_tensor(self.r_np, self.device)   # (16,)
        self.r2 = to_tensor(self.r2_np, self.device)
        self.one_std = to_tensor(int_to_limbs_np(1), self.device)

    # -- host helpers -----------------------------------------------------
    def to_mont_int(self, x: int) -> int:
        return (x * self.R) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * self.R_inv) % self.p

    def encode_np(self, xs) -> np.ndarray:
        """Ints (reduced mod p here) -> (16, N) uint32 Montgomery limbs
        (numpy), through the host codec (native/)."""
        return native.encode_mont_np(xs, self)

    def plain_encode_np(self, xs) -> np.ndarray:
        """`encode_np`'s plain version: one Python product a value."""
        return ints_to_limbs_np([self.to_mont_int(operator.index(x) % self.p)
                                 for x in xs])

    def encode(self, xs) -> torch.Tensor:
        """Canonical values -> (16, N) Montgomery limbs on the device."""
        return to_tensor(self.encode_np(xs), self.device)

    def encode_scalar(self, x: int) -> torch.Tensor:
        """One canonical value -> (16,) Montgomery limbs on the device."""
        return to_tensor(int_to_limbs_np(self.to_mont_int(x % self.p)),
                         self.device)

    def decode_le_rows(self, fill, C: int, n: int, mask: bool = False):
        """C columns of n canonical little-endian 32-byte rows, column after
        column -> ((16, C, n) Montgomery limbs, (C, 5) int64 stats) on the
        device (`cuda_ops.decode_le32`; `mask`: 253 bits a row).
        fill(view) writes the 32 C n bytes into a writable uint8 numpy
        array: for a CUDA device the pinned staging buffer, which goes up
        as it is (32 bytes a value) and is decoded by one launch."""
        nbytes = 32 * C * n
        cuda = self.device.type == "cuda"
        host = (cuda_ops.staging(nbytes) if cuda
                else torch.empty(nbytes, dtype=torch.uint8))
        fill(host.numpy())
        rows = cuda_ops.upload(host, self.device) if cuda else host
        return cuda_ops.decode_le32(
            self, rows.view(torch.int32).reshape(C, n, 8), mask)

    def encode_le_bytes_dev(self, blob, n: int) -> torch.Tensor:
        """n canonical 32-byte little-endian values (< p; a bytes-like
        buffer or a contiguous numpy view) -> (16, n) Montgomery limbs,
        decoded on the device (`decode_le_rows`)."""
        src = np.frombuffer(blob, dtype=np.uint8)
        if src.size != 32 * n:
            raise ValueError(f"{src.size} bytes are not {n} 32-byte rows")

        def fill(view):
            view[:] = src
        return self.decode_le_rows(fill, 1, n)[0][:, 0, :]

    def encode_u64_dev(self, cols: np.ndarray) -> torch.Tensor:
        """(C, n) uint64 canonical values -> (16, C, n) Montgomery limbs,
        with the canonical->Montgomery conversion on the device (8 bytes a
        value go up instead of 64)."""
        cols = np.ascontiguousarray(cols, dtype="<u8")
        quarters = cols.view("<u2").reshape(cols.shape[0], cols.shape[1], 4)
        low = to_tensor(np.ascontiguousarray(quarters.transpose(2, 0, 1)),
                        self.device)                  # (4, C, n)
        x = torch.zeros((N_LIMBS,) + tuple(cols.shape), dtype=DTYPE,
                        device=self.device)
        x[:4] = low
        return self.to_mont(x)

    def decode(self, limbs) -> list:
        """(16, N) Montgomery limbs -> list of canonical Python ints,
        through the host codec (native/)."""
        arr = to_numpy(limbs) if isinstance(limbs, torch.Tensor) \
            else np.asarray(limbs)
        return native.decode_mont_np(arr, self)

    def plain_decode(self, limbs) -> list:
        """`decode`'s plain version: one Python product a value."""
        arr = to_numpy(limbs) if isinstance(limbs, torch.Tensor) \
            else np.asarray(limbs)
        return [self.from_mont_int(v) for v in limbs_to_ints(arr)]

    def decode_scalar(self, limbs) -> int:
        arr = to_numpy(limbs) if isinstance(limbs, torch.Tensor) \
            else np.asarray(limbs)
        return self.from_mont_int(limbs_to_int(arr))

    # -- constants ----------------------------------------------------------
    def zeros(self, batch_shape) -> torch.Tensor:
        return torch.zeros((N_LIMBS,) + tuple(batch_shape), dtype=DTYPE,
                           device=self.device)

    def broadcast_scalar(self, limbs16, batch_shape) -> torch.Tensor:
        """(16,) -> (16, *batch), a broadcast view."""
        if not isinstance(limbs16, torch.Tensor):
            limbs16 = to_tensor(np.asarray(limbs16), self.device)
        batch_shape = tuple(batch_shape)
        return limbs16.reshape((N_LIMBS,) + (1,) * len(batch_shape)).expand(
            (N_LIMBS,) + batch_shape)

    def ones(self, batch_shape) -> torch.Tensor:
        """1 in Montgomery form, materialised at (16, *batch)."""
        return self.broadcast_scalar(self.one, batch_shape).contiguous()

    # -- modular ops ------------------------------------------------------
    def add(self, a, b):
        return cuda_ops.binop("add", self, a, b)

    def sub(self, a, b):
        return cuda_ops.binop("sub", self, a, b)

    def mul(self, a, b):
        """Montgomery product a*b/R mod p (both operands in Montgomery form
        give the product in Montgomery form)."""
        return cuda_ops.binop("mul", self, a, b)

    def neg(self, a):
        """p - a, and 0 for 0: a subtraction from the single element 0."""
        return self.sub(torch.zeros(N_LIMBS, dtype=DTYPE, device=a.device), a)

    def square(self, a):
        return self.mul(a, a)

    def to_mont(self, a_std):
        """standard-form limbs -> Montgomery form."""
        return self.mul(a_std, self.r2.to(a_std.device))

    def from_mont(self, a_mont):
        """Montgomery form -> standard-form limbs (canonical, < p)."""
        return self.mul(a_mont, self.one_std.to(a_mont.device))

    def pow_static(self, a, e: int):
        """a**e for a Python-int exponent: one kernel launch for a CUDA
        tensor (fields/cuda_ops.py), the plain version on the CPU."""
        if a.device.type == "cuda":
            return cuda_ops.pow_static(self, a, e)
        return self.plain_pow_static(a, e)

    def plain_pow_static(self, a, e: int):
        """`pow_static`'s plain version, on any device: square and
        multiply, most significant bit first, one plain product a step."""
        if e == 0:
            return self.broadcast_scalar(
                self.one.to(a.device), a.shape[1:]).contiguous()
        res = a
        for bit in bin(e)[3:]:
            res = cuda_ops.plain_op("mul", self, res, res)
            if bit == "1":
                res = cuda_ops.plain_op("mul", self, res, a)
        return res

    def inv(self, a):
        """The inverse (0 -> 0): one safegcd kernel launch for a CUDA tensor
        (fields/cuda_ops.py), the plain Fermat power a^(p-2) on the CPU;
        both give the canonical value."""
        if a.device.type == "cuda":
            return cuda_ops.inv(self, a)
        return self.plain_pow_static(a, self.p - 2)

    def prefix_mul(self, a, reverse: bool = False, block: int = 1024):
        """Inclusive prefix products of a (16, N) vector, from the end if
        `reverse`: one kernel launch for a CUDA tensor (fields/cuda_ops.py,
        which tiles as suits the card), the plain version on the CPU."""
        if a.ndim != 2:
            raise ValueError("prefix_mul expects (16, N)")
        if a.device.type == "cuda":
            return cuda_ops.prefix_mul(self, a, reverse)
        return self.plain_prefix_mul(a, reverse, block)

    def plain_prefix_mul(self, a, reverse: bool = False, block: int = 1024):
        """`prefix_mul`'s plain version, on any device.

        Two-level blocked scan: N = B*S elements are laid out as B
        contiguous chunks of length S; S steps compute the running products
        of every chunk at once (one mul of width B a step), a short
        sequential pass chains the chunk totals, and one full-width mul
        folds the chunk prefixes in."""
        if a.ndim != 2:
            raise ValueError("prefix_mul expects (16, N)")
        n = a.shape[1]
        if reverse:
            return self.plain_prefix_mul(a.flip(1), block=block).flip(1)

        def mul(x, y):
            return cuda_ops.plain_op("mul", self, x, y)

        B = min(block, n)
        S = -(-n // B)
        pad = B * S - n
        one = self.one.to(a.device)
        if pad:
            a = torch.cat([a, self.broadcast_scalar(one, (pad,))], 1)
        x = a.reshape(N_LIMBS, B, S)
        steps = [x[:, :, 0]]
        for s in range(1, S):
            steps.append(mul(steps[-1], x[:, :, s]))
        chunk_pref = torch.stack(steps, dim=2)            # (16, B, S)
        totals = steps[-1]                                # (16, B)
        excl = [one[:, None]]
        for b in range(B - 1):
            excl.append(mul(excl[-1], totals[:, b:b + 1]))
        excl = torch.cat(excl, dim=1)                     # (16, B) exclusive
        out = mul(chunk_pref, excl[:, :, None])
        return out.reshape(N_LIMBS, B * S)[:, :n]

    def batch_inverse(self, a):
        """Montgomery-trick batch inversion of a (16, N) vector (one field
        inversion + O(N) muls via blocked prefix/suffix product scans).
        Zeros map to zeros (the reference's batch_invert semantics)."""
        if a.ndim != 2:
            raise ValueError("batch_inverse expects (16, N)")
        zmask = is_zero(a)[None]  # (1, N)
        one = self.broadcast_scalar(self.one.to(a.device), a.shape[1:])
        aa = torch.where(zmask, one, a)

        pref = self.prefix_mul(aa)
        suf = self.prefix_mul(aa, reverse=True)
        total_inv = self.inv(pref[:, -1:])  # (16, 1)
        # inv(a_i) = prefix_{i-1} * suffix_{i+1} * total_inv
        left = torch.cat([one[:, :1], pref[:, :-1]], dim=1)
        right = torch.cat([suf[:, 1:], one[:, :1]], dim=1)
        out = self.mul(self.mul(left, right), total_inv)
        return torch.where(zmask, torch.zeros_like(a), out)
