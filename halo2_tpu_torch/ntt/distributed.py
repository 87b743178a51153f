"""Four-step NTT over a mesh of devices (the port of the JAX package's
ntt/distributed.py).

The classic four-step / Bailey decomposition, sharded on columns:

  N = n1 * n2, A[i1, i2] = x[i1*n2 + i2], shard d owns the columns
  i2 in [d*n2/D, (d+1)*n2/D):
    1. local length-n1 NTTs along i1 (each shard owns whole columns)
    2. local twiddle  B[k1, i2] *= w^(k1*i2), i2 offset by the shard's
       first column (one product of the shared-table kernel)
    3. `all_to_all` so that each shard owns n1/D rows k1, local length-n2
       NTTs along i2
    4. `all_to_all` back, so that the output X[k2*n1 + k1] is row-sharded
       in contiguous blocks of k2 — natural order, ready for elementwise
       stages.

Each local transform is the port's single-device `NTT` (its butterfly and
shared-table kernels) on the shard's device, so the result equals
`NTT.forward` / `inverse` / `inverse_nodiv` word for word.  Arrays carry
leading batch dims: (16, *B, n) whole, (16, *B, n1, n2/D) a shard's
column slice, (16, *B, n/D) a row shard of the output.
"""

from __future__ import annotations

import torch

from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields.bn254 import FR_MODULUS, fr
from halo2_tpu_torch.fields.limbs import N_LIMBS
from halo2_tpu_torch.ntt.ntt import NTT, get_ntt, powers_dev, take
from halo2_tpu_torch.utils import mesh as mesh_mod
from halo2_tpu_torch.utils import profiling

P = FR_MODULUS


def twiddle_grid(F, w: int, rows: int, col0: int, cols: int):
    """(16, rows, cols) Montgomery limbs of w^(k1 * i2) for k1 < rows and
    i2 in [col0, col0 + cols), built on F's device: the first column and
    the per-row step are power tables, and each round doubles the columns
    (grid_{2m} = [grid_m, grid_m * step^m]) — rows * cols products in all,
    never a host loop over the grid."""
    start = powers_dev(F, pow(w, col0, P), rows)[:, :, None]   # w^(k1*col0)
    step = powers_dev(F, w, rows)[:, :, None]                  # w^k1
    grid, m = start, 1
    while m < cols:
        take_ = min(m, cols - m)
        grid = torch.cat([grid, F.mul(grid[:, :, :take_], step)], dim=2)
        step = F.mul(step, step)                               # w^(k1*2m)
        m += take_
    return grid.contiguous()


class DistNTT:
    """Four-step NTT of size 2^log_n sharded over mesh axis `axis`
    (D devices, a power of two)."""

    def __init__(self, log_n: int, mesh, axis: str = "x",
                 omega: int | None = None):
        self.log_n = log_n
        self.n = 1 << log_n
        self.devices = mesh.devices_of(axis)
        self.D = len(self.devices)
        if self.D & (self.D - 1):
            raise ValueError("the device count must be a power of two")
        self.log_d = self.D.bit_length() - 1
        # n1 rows x n2 columns; both must split over the D devices
        self.log_n1 = log_n // 2
        self.log_n2 = log_n - self.log_n1
        assert min(self.log_n1, self.log_n2) >= self.log_d, \
            "n too small for this device count"
        self.n1, self.n2 = 1 << self.log_n1, 1 << self.log_n2
        self.L2 = self.n2 // self.D
        if omega is None:
            omega = get_ntt(log_n, self.devices[0]).omega
        self.omega = omega
        self.omega_inv = pow(omega, P - 2, P)
        self.n_inv = pow(self.n, P - 2, P)
        self._ntts = {}
        self._tw = {}

    # -- per-device contexts and tables ----------------------------------
    def _ntt(self, log_m: int, root: int, device) -> NTT:
        key = (log_m, root, str(device))
        ntt = self._ntts.get(key)
        if ntt is None:
            ntt = self._ntts[key] = NTT(log_m, device, root)
        return ntt

    def _twiddles(self, inverse: bool) -> list:
        """Each shard's (16, n1 * n2/D) twiddle table w^(k1*i2) on its
        device (cached until drop_tables)."""
        tabs = self._tw.get(inverse)
        if tabs is None:
            w = self.omega_inv if inverse else self.omega
            tabs = self._tw[inverse] = [
                twiddle_grid(fr(dev), w, self.n1, d * self.L2,
                             self.L2).reshape(N_LIMBS, -1)
                for d, dev in enumerate(self.devices)]
        return tabs

    def drop_tables(self):
        """Release every shard's twiddle tables (n/D words a shard and
        direction; the local transforms' tables are of sqrt(n) and
        stay)."""
        self._tw.clear()

    # -- the shard-local transform ----------------------------------------
    def _local_transform(self, slices: list, inverse: bool) -> list:
        """slices: per shard (16, *B, n1, n2/D), this shard's columns of the
        (n1, n2) view.  Returns per shard (16, *B, (n2/D)*n1): the
        k2-contiguous row shard of the flat output."""
        w = self.omega_inv if inverse else self.omega
        n1, n2, D = self.n1, self.n2, self.D
        root1, root2 = pow(w, n2, P), pow(w, n1, P)
        tws = self._twiddles(inverse)
        batch = tuple(slices[0].shape[1:-2])
        out = []
        for d, dev in enumerate(self.devices):
            x = slices[d]
            slices[d] = None
            # step 1: length-n1 NTTs along the rows (each column whole)
            a = self._ntt(self.log_n1, root1, dev).forward(
                [x.transpose(-1, -2).contiguous()])           # [i2, k1]
            del x
            a = a.transpose(-1, -2).contiguous()              # [k1, i2]
            # step 2: the twiddle w^(k1*i2), i2 from this shard's first column
            a = cuda_ops.mul_tiled(fr(dev), a.reshape(
                (N_LIMBS,) + batch + (n1 * self.L2,)), tws[d])
            out.append(a.reshape((N_LIMBS,) + batch + (n1, self.L2)))
        # step 3: shard on k1, length-n2 NTTs along i2
        nd = len(batch) + 3
        out = mesh_mod.all_to_all(out, self.devices, nd - 2, nd - 1)
        for d, dev in enumerate(self.devices):
            c = self._ntt(self.log_n2, root2, dev).forward([out[d]])
            out[d] = c.transpose(-1, -2).contiguous()         # [k2, k1_loc]
        # step 4: back to k2-contiguous rows: X[k2*n1 + k1]
        out = mesh_mod.all_to_all(out, self.devices, nd - 2, nd - 1)
        return [o.reshape((N_LIMBS,) + batch + (self.L2 * n1,))
                for o in out]

    def local_forward(self, slices: list) -> list:
        """Forward transform of the shards' column slices (consumed)."""
        profiling.incr("dist_ntt_calls")
        return self._local_transform(slices, inverse=False)

    def local_inverse_nodiv(self, slices: list) -> list:
        """Inverse transform, no 1/n divisor, of the column slices."""
        profiling.incr("dist_ntt_calls")
        return self._local_transform(slices, inverse=True)

    def local_slice_from_flat(self, x_flat) -> list:
        """(16, *B, n) whole -> per shard (16, *B, n1, n2/D), its columns
        of the (n1, n2) view x[i1*n2 + i2], on its device."""
        v = x_flat.reshape(tuple(x_flat.shape[:-1]) + (self.n1, self.n2))
        return mesh_mod.scatter(v, self.devices, dim=-1)

    def local_slices_from_rows(self, shards: list) -> list:
        """Row shards (16, *B, n/D) — contiguous blocks, as the transforms
        and the sharded evaluator give them — -> the column slices the
        four-step reads: one all_to_all."""
        nd = shards[0].ndim + 1
        v = [s.reshape(tuple(s.shape[:-1]) + (self.n1 // self.D, self.n2))
             for s in shards]
        return mesh_mod.all_to_all(v, self.devices, nd - 1, nd - 2)

    # -- whole-array entry points -------------------------------------------
    def _slices(self, x) -> list:
        """A transform's input as column slices: a whole (16, *B, n)
        tensor or a row-sharded ShardedArray, either of them alone or
        handed over in a one-element list."""
        x = take(x)
        if isinstance(x, mesh_mod.ShardedArray):
            return self.local_slices_from_rows(x.shards)
        if x.shape[-1] != self.n:
            raise ValueError(f"DistNTT of size {self.n} got last axis "
                             f"{x.shape[-1]}")
        return self.local_slice_from_flat(x)

    def forward(self, x) -> mesh_mod.ShardedArray:
        """Coefficients -> evaluations in natural order, row-sharded."""
        return mesh_mod.ShardedArray(self.local_forward(self._slices(x)))

    def inverse_nodiv(self, x) -> mesh_mod.ShardedArray:
        """Inverse transform WITHOUT the 1/n divisor, row-sharded (callers
        fold the divisor into other constants)."""
        return mesh_mod.ShardedArray(
            self.local_inverse_nodiv(self._slices(x)))

    def inverse(self, x) -> mesh_mod.ShardedArray:
        """Inverse transform with the 1/n divisor, row-sharded: equal word
        for word to NTT.inverse.  Backs the prover's step-7 iNTTs under
        params.use_mesh."""
        out = self.inverse_nodiv(x)
        return out.map(lambda s: fr(s.device).mul(
            s, fr(s.device).encode_scalar(self.n_inv)))
