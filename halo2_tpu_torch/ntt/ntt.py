"""Number-theoretic transform over BN254 Fr on limb tensors.

  * **Four-step (Bailey) decomposition.**  n = n1*n2; view the input as
    (n2, n1) [i2 rows, i1 columns], run an n2-point NTT along the ROW axis
    (per column), multiply by the mid twiddles w^{i1*k2}, transpose the two
    axes, run an n1-point NTT along the row axis, and read the result flat —
    natural order.  Butterflies pair *rows*, so every stage reads and
    writes contiguous row slices; data moves across rows exactly once, in
    the middle transpose.
  * Each small NTT is radix-2 DIF (natural order in, bit-reversed out; the
    bit-reversal is a row gather), every stage one launch of the butterfly
    kernel (fields/cuda_ops.butterfly): u = lo + hi, v = (lo - hi) * w.
  * Stage twiddles are tiny (16, h) tables; the mid twiddle table is the
    only n-sized constant, applied by the shared-table product kernel
    (fields/cuda_ops.mul_tiled).

Transforms are along the LAST axis; arrays are limbs-leading
``(16, *batch, n)``.  An NTT context allocates its tables on one explicit
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields.bn254 import (FR_MODULUS, FR_ROOT_OF_UNITY, FR_S,
                                          fr)
from halo2_tpu_torch.fields.limbs import N_LIMBS, ints_to_limbs_np, to_tensor
from halo2_tpu_torch.utils import profiling


@functools.lru_cache(maxsize=None)
def bit_reverse_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def powers_table_np(base: int, count: int, p: int, to_mont) -> np.ndarray:
    """(16, count) Montgomery limbs of base^0..base^{count-1}."""
    vals = []
    acc = 1
    for _ in range(count):
        vals.append(to_mont(acc))
        acc = acc * base % p
    return ints_to_limbs_np(vals)


class NTT:
    """NTT context for one domain size n = 2^log_n with root omega.

    omega: a primitive n-th root of unity in Fr (canonical int form).
    """

    def __init__(self, log_n: int, device, omega: int | None = None):
        if log_n > FR_S:
            raise ValueError(f"2^{log_n} exceeds Fr 2-adicity 2^{FR_S}")
        self.device = torch.device(device)
        self.F = fr(self.device)
        self.log_n = log_n
        self.n = 1 << log_n
        if omega is None:
            omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - log_n), FR_MODULUS)
        self.omega = omega
        self.omega_inv = pow(omega, FR_MODULUS - 2, FR_MODULUS)
        self.n_inv = pow(self.n, FR_MODULUS - 2, FR_MODULUS)
        self.n_inv_mont = self.F.encode_scalar(self.n_inv)

        # four-step split: n = n1 * n2, n1 = 2^ceil(L/2)
        self.l1 = (log_n + 1) // 2
        self.n1 = 1 << self.l1
        self.n2 = self.n >> self.l1
        self._tables_cache = {}

    # -- twiddle tables -----------------------------------------------------
    def _tables(self, inverse: bool):
        """Device tables for one direction (cached).

        {'inner': [(16, h) per stage of the n2-point NTT],
         'outer': [(16, h) per stage of the n1-point NTT],
         'mid':   (16, n2*n1) w^{i1*k2},
         'rev1':  (n1,) bit-reverse, 'rev2': (n2,)}
        """
        if inverse in self._tables_cache:
            return self._tables_cache[inverse]
        w = self.omega_inv if inverse else self.omega
        n, n1, n2 = self.n, self.n1, self.n2
        # full power table once (O(n) bigint muls), then slice/gather
        full = powers_table_np(w, max(n, 1), FR_MODULUS, self.F.to_mont_int)

        def stage_tables(m: int, root_step: int):
            # m-point NTT with root w^root_step; stage s twiddle
            # tw[j] = (w^root_step)^(j * 2^s), j in [0, m >> (s+1))
            out = []
            for s in range(m.bit_length() - 1):
                h = m >> (s + 1)
                idx = (np.arange(h, dtype=np.int64) << s) * root_step % n
                out.append(to_tensor(full[:, idx], self.device))
            return out

        i1 = np.arange(n1, dtype=np.int64)
        k2 = np.arange(n2, dtype=np.int64)
        mid_idx = (k2[:, None] * i1[None, :]) % n          # (n2, n1)
        tables = {
            "inner": stage_tables(n2, n1),
            "outer": stage_tables(n1, n2),
            "mid": to_tensor(full[:, mid_idx.reshape(-1)], self.device),
            "rev1": torch.from_numpy(bit_reverse_indices(self.l1)).to(
                self.device),
            "rev2": torch.from_numpy(
                bit_reverse_indices(self.log_n - self.l1)).to(self.device),
        }
        self._tables_cache[inverse] = tables
        return tables

    # ------------------------------------------------------------------
    def _small_ntt(self, x, stage_tws, rev):
        """Radix-2 DIF along axis 2. x: (16, B, m, w) contiguous; natural
        order in, natural order out (bit-reversal undone by a row gather).

        Stage s splits each block of 2h rows into (lo, hi) halves —
        contiguous row slices — and one butterfly launch writes
        [lo + hi, (lo - hi) * tw] back in the same block layout, so the
        output of a stage is the next stage's input as it stands."""
        L = len(stage_tws)
        if L == 0:
            return x
        m = 1 << L
        _, B, _, w = x.shape
        for s, tw in enumerate(stage_tws):
            h = m >> (s + 1)
            xb = x.reshape(N_LIMBS, B << s, 2, h * w)
            x = cuda_ops.butterfly(self.F, xb[:, :, 0, :], xb[:, :, 1, :],
                                   tw, rep=w)
        return x.reshape(N_LIMBS, B, m, w).index_select(2, rev)

    def _transform(self, a, tables):
        """Four-step NTT along the last axis. a: (16, *mid, n) Montgomery
        limbs; returns the same shape, natural order."""
        n, n1, n2 = self.n, self.n1, self.n2
        if n == 1:
            return a
        shape = a.shape
        if shape[-1] != n:
            raise ValueError(f"NTT of size {n} got last axis {shape[-1]}")
        B = a.numel() // (N_LIMBS * n)
        x = a.contiguous().reshape(N_LIMBS, B, n2, n1)       # [i2, i1]
        x = self._small_ntt(x, tables["inner"], tables["rev2"])  # [k2, i1]
        x = cuda_ops.mul_tiled(self.F, x.reshape(N_LIMBS, B, n2 * n1),
                               tables["mid"])
        x = x.reshape(N_LIMBS, B, n2, n1).transpose(2, 3).contiguous()
        x = self._small_ntt(x, tables["outer"], tables["rev1"])  # [k1, k2]
        return x.reshape(shape)

    def forward(self, a):
        """Coefficients -> evaluations at {omega^i}. a: (16, *mid, n)."""
        profiling.incr("ntt_calls")
        return self._transform(a, self._tables(False))

    def inverse(self, a):
        """Evaluations -> coefficients (divides by n)."""
        return self.F.mul(self.inverse_nodiv(a), self.n_inv_mont)

    def inverse_nodiv(self, a):
        """Inverse transform WITHOUT the 1/n divisor (callers fold the
        divisor into other constants, like the reference's ifft_divisor)."""
        profiling.incr("ntt_calls")
        return self._transform(a, self._tables(True))


@functools.lru_cache(maxsize=None)
def _get_ntt(log_n: int, device: str) -> NTT:
    return NTT(log_n, device)


def get_ntt(log_n: int, device) -> NTT:
    """Cached standard-domain NTT (omega = canonical 2^log_n root)."""
    return _get_ntt(log_n, str(torch.device(device)))
