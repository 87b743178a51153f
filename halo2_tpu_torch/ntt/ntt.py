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
    (fields/cuda_ops.mul_tiled).  Every table is built on the device from
    one powers table (log2 n doubling rounds of products), so dropping the
    tables between a proof's phases (`drop_tables`) costs a rebuild of
    milliseconds, not a host loop over n big integers.
  * Large domains: `inverse_streamed_nodiv` runs the same four steps in
    lane chunks, so its live memory is input + output + mid table + one
    chunk; and a transform handed its input in a one-element list takes
    it over and lets it go as soon as it is read (the reference's donated
    buffers).

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
from halo2_tpu_torch.fields.limbs import N_LIMBS, ints_to_limbs_np
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


def powers_dev(F, base: int, count: int) -> torch.Tensor:
    """powers_table_np's words, built on F's device in log2(count)
    doubling rounds (tab_{2m} = [tab_m, tab_m * base^m]): count products
    in all."""
    tab = F.ones((1,))
    cur = F.encode_scalar(base)[:, None]          # base^m, m = 1
    m = 1
    while m < count:
        step = min(m, count - m)
        tab = torch.cat([tab, F.mul(tab[:, :step], cur)], dim=1)
        cur = F.mul(cur, cur)                     # base^{2m}
        m += step
    return tab[:, :count]


def take(a):
    """A transform's input: a tensor, which the caller keeps, or a
    one-element list holding one, which hands it over — the transform
    takes it out of the list and lets it go once it has read it, so the
    caller's last reference is gone before the output is allocated (the
    counterpart of the reference's donated inputs, ntt.py:231-238)."""
    if isinstance(a, list):
        if len(a) != 1:
            raise ValueError("hand a transform its input in a one-element "
                             "list")
        return a.pop()
    return a


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
        """Device tables for one direction (cached until drop_tables).

        {'inner': [(16, h) per stage of the n2-point NTT],
         'outer': [(16, h) per stage of the n1-point NTT],
         'mid':   (16, n2*n1) w^{i1*k2},
         'rev1':  (n1,) bit-reverse, 'rev2': (n2,)}
        """
        if inverse in self._tables_cache:
            return self._tables_cache[inverse]
        w = self.omega_inv if inverse else self.omega
        n, n1, n2 = self.n, self.n1, self.n2
        dev = self.device
        # the full power table once, on the device; then gathers
        full = powers_dev(self.F, w, max(n, 1))

        def stage_tables(m: int, root_step: int):
            # m-point NTT with root w^root_step; stage s twiddle
            # tw[j] = (w^root_step)^(j * 2^s), j in [0, m >> (s+1))
            out = []
            for s in range(m.bit_length() - 1):
                h = m >> (s + 1)
                idx = (np.arange(h, dtype=np.int64) << s) * root_step % n
                out.append(full.index_select(
                    1, torch.from_numpy(idx).to(dev)))
            return out

        i1 = torch.arange(n1, dtype=torch.int64, device=dev)
        k2 = torch.arange(n2, dtype=torch.int64, device=dev)
        mid_idx = (k2[:, None] * i1[None, :]) % n          # (n2, n1)
        tables = {
            "inner": stage_tables(n2, n1),
            "outer": stage_tables(n1, n2),
            "mid": full.index_select(1, mid_idx.reshape(-1)),
            "rev1": torch.from_numpy(bit_reverse_indices(self.l1)).to(dev),
            "rev2": torch.from_numpy(
                bit_reverse_indices(self.log_n - self.l1)).to(dev),
        }
        self._tables_cache[inverse] = tables
        return tables

    def drop_tables(self, inverse: bool | None = None):
        """Release the cached tables of one direction (None: both) — the
        mid table is 64 bytes an element, 512 MiB at 2^23.  The next
        transform in that direction builds them again on the device
        (the counterpart of the reference's drop_dev_tables)."""
        for key in list(self._tables_cache):
            if inverse is None or key == inverse:
                del self._tables_cache[key]

    # ------------------------------------------------------------------
    def _small_ntt(self, box, stage_tws, rev):
        """Radix-2 DIF along axis 2. box: a one-element list holding x,
        (16, B, m, w) contiguous, which is let go after the first stage;
        natural order in, natural order out (bit-reversal undone by a row
        gather).

        Stage s splits each block of 2h rows into (lo, hi) halves —
        contiguous row slices — and one butterfly launch writes
        [lo + hi, (lo - hi) * tw] back in the same block layout, so the
        output of a stage is the next stage's input as it stands."""
        x = take(box)
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
        del xb                     # two buffers live at a time, not three
        return x.reshape(N_LIMBS, B, m, w).index_select(2, rev)

    def _transform(self, a, tables):
        """Four-step NTT along the last axis. a: (16, *mid, n) Montgomery
        limbs, or a one-element list handing it over; returns the same
        shape, natural order."""
        a = take(a)
        n, n1, n2 = self.n, self.n1, self.n2
        if n == 1:
            return a
        shape = a.shape
        if shape[-1] != n:
            raise ValueError(f"NTT of size {n} got last axis {shape[-1]}")
        B = a.numel() // (N_LIMBS * n)
        box = [a.contiguous().reshape(N_LIMBS, B, n2, n1)]   # [i2, i1]
        del a
        x = self._small_ntt(box, tables["inner"], tables["rev2"])  # [k2, i1]
        x = cuda_ops.mul_tiled(self.F, x.reshape(N_LIMBS, B, n2 * n1),
                               tables["mid"])
        box = [x.reshape(N_LIMBS, B, n2, n1).transpose(2, 3).contiguous()]
        del x
        x = self._small_ntt(box, tables["outer"], tables["rev1"])  # [k1, k2]
        return x.reshape(shape)

    def forward(self, a):
        """Coefficients -> evaluations at {omega^i}. a: (16, *mid, n), or a
        one-element list handing it over."""
        profiling.incr("ntt_calls")
        return self._transform(a, self._tables(False))

    def inverse(self, a):
        """Evaluations -> coefficients (divides by n).  Handed its input in
        a one-element list, it stands for the reference's inverse_donated
        (ntt.py:231-238): the caller's last reference is gone before the
        output exists."""
        return self.F.mul(self.inverse_nodiv(a), self.n_inv_mont)

    def inverse_nodiv(self, a):
        """Inverse transform WITHOUT the 1/n divisor (callers fold the
        divisor into other constants, like the reference's ifft_divisor)."""
        profiling.incr("ntt_calls")
        return self._transform(a, self._tables(True))

    def inverse_streamed_nodiv(self, a, chunks_log: int = 3):
        """inverse_nodiv of one (16, n) column in lane chunks, the
        large-domain path (the reference's ntt.py:247-300): the four steps
        cut into 2^chunks_log chunks a half —

          phase 1, a chunk of i1 lanes at a time: the inner n2-point NTT,
            the mid twiddle, the transpose, written into one preallocated
            (16, n1, n2) output;
          phase 2, a chunk of k2 lanes at a time: the outer n1-point NTT,
            written back in place.

        The input is let go after phase 1 when it was handed over in a
        one-element list, so live memory is input + output + mid table +
        one chunk's temporaries.  The same butterflies, twiddles and order
        as inverse_nodiv: equal to it word for word."""
        a = take(a)
        n, n1, n2 = self.n, self.n1, self.n2
        if tuple(a.shape) != (N_LIMBS, n):
            raise ValueError(f"streamed NTT of size {n} takes (16, {n}), "
                             f"got {tuple(a.shape)}")
        profiling.incr("ntt_calls")
        profiling.incr("ntt_streamed_calls")
        tables = self._tables(True)
        w1 = max(n1 >> chunks_log, 1)
        w2 = max(n2 >> chunks_log, 1)
        x = a.contiguous().reshape(N_LIMBS, n2, n1)          # [i2, i1]
        del a
        mid = tables["mid"].reshape(N_LIMBS, n2, n1)
        out = torch.empty((N_LIMBS, n1, n2), dtype=torch.int32,
                          device=x.device)
        for c0 in range(0, n1, w1):
            y = self._small_ntt(
                [x[:, :, c0:c0 + w1].contiguous().reshape(
                    N_LIMBS, 1, n2, w1)], tables["inner"], tables["rev2"])
            y = cuda_ops.mul_tiled(
                self.F, y.reshape(N_LIMBS, n2 * w1),
                mid[:, :, c0:c0 + w1].reshape(N_LIMBS, n2 * w1))
            out[:, c0:c0 + w1, :] = y.reshape(N_LIMBS, n2, w1).transpose(1, 2)
        del x, y                                             # the input
        for c0 in range(0, n2, w2):
            y = self._small_ntt(
                [out[:, :, c0:c0 + w2].contiguous().reshape(
                    N_LIMBS, 1, n1, w2)], tables["outer"], tables["rev1"])
            out[:, :, c0:c0 + w2] = y.reshape(N_LIMBS, n1, w2)
        return out.reshape(N_LIMBS, n)


@functools.lru_cache(maxsize=None)
def _get_ntt(log_n: int, device: str) -> NTT:
    return NTT(log_n, device)


def get_ntt(log_n: int, device) -> NTT:
    """Cached standard-domain NTT (omega = canonical 2^log_n root)."""
    return _get_ntt(log_n, str(torch.device(device)))
