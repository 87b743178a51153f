"""Evaluation domain: the Fr polynomial-domain machinery.

Re-design of `EvaluationDomain` (halo2_proofs/src/poly/domain.rs:24-131):
the host holds all scalar constants as Python ints (exact), the device
holds polynomial values as ``(16, n)`` int32 Montgomery limb tensors, and
every transform below is built from the NTT layer and the shared-table
product kernel.

Bases (mirroring poly.rs:37-64):
  "coeff"    — coefficient form, length n
  "lagrange" — evaluations over {omega^i}, length n
  "extended" — evaluations over zeta*{extended_omega^i}, length 2^extended_k
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields.bn254 import FR_MODULUS, FR_ZETA, fr
from halo2_tpu_torch.fields.limbs import N_LIMBS, ints_to_limbs_np, to_tensor
from halo2_tpu_torch.ntt.distributed import DistNTT
from halo2_tpu_torch.ntt.ntt import get_ntt
from halo2_tpu_torch.utils.mesh import ShardedArray, gather

P = FR_MODULUS

# extended domains from this size on take the streamed inverse transform
# in extended_to_coeff (the reference's HALO2_TPU_STREAM_NTT_MIN default)
STREAM_NTT_MIN = 1 << 23


@dataclass
class Polynomial:
    """A polynomial as device limb values plus a basis tag."""
    values: torch.Tensor  # (16, len)
    basis: str

    def __len__(self):
        return self.values.shape[1]

    def _same_basis(self, other):
        if self.basis != other.basis:
            raise ValueError(f"basis mismatch: {self.basis} vs {other.basis}")

    def __add__(self, other):
        self._same_basis(other)
        F = fr(self.values.device)
        return Polynomial(F.add(self.values, other.values), self.basis)

    def __sub__(self, other):
        self._same_basis(other)
        F = fr(self.values.device)
        return Polynomial(F.sub(self.values, other.values), self.basis)

    def scale(self, c_limbs):
        """Multiply by a scalar given as (16,) Montgomery limbs."""
        F = fr(self.values.device)
        return Polynomial(F.mul(self.values, c_limbs), self.basis)


class EvaluationDomain:
    """Domain for circuits with n = 2^k rows and max constraint degree j,
    with its tables on one explicit device."""

    def __init__(self, j: int, k: int, device):
        self.device = torch.device(device)
        self.F = fr(self.device)
        self.k = k
        self.n = 1 << k
        self.quotient_poly_degree = max(j - 1, 1)
        extended_k = k
        while (1 << extended_k) < self.n * self.quotient_poly_degree:
            extended_k += 1
        self.extended_k = extended_k
        self.extended_n = 1 << extended_k

        self.ntt = get_ntt(k, self.device)
        self.ntt_ext = get_ntt(extended_k, self.device)
        self.omega = self.ntt.omega
        self.omega_inv = self.ntt.omega_inv
        self.extended_omega = self.ntt_ext.omega
        self.extended_omega_inv = self.ntt_ext.omega_inv

        self.g_coset = FR_ZETA
        self.g_coset_inv = FR_ZETA * FR_ZETA % P
        self.barycentric_weight = pow(self.n, P - 2, P)

        # t(zeta * ext_omega^i) = zeta^n * ext_omega^{n i} - 1, period 2^(ext_k-k)
        period = 1 << (extended_k - k)
        orig = pow(self.g_coset, self.n, P)
        step = pow(self.extended_omega, self.n, P)
        t_evals = []
        cur = orig
        for _ in range(period):
            t_evals.append((cur - 1) % P)
            cur = cur * step % P
        self.t_evaluations_inv = [pow(t, P - 2, P) for t in t_evals]
        self._dist = {}

    # -- constructors ------------------------------------------------------
    def empty_lagrange(self) -> Polynomial:
        return Polynomial(self.F.zeros((self.n,)), "lagrange")

    def empty_coeff(self) -> Polynomial:
        return Polynomial(self.F.zeros((self.n,)), "coeff")

    def empty_extended(self) -> Polynomial:
        return Polynomial(self.F.zeros((self.extended_n,)), "extended")

    def constant_lagrange(self, c: int) -> Polynomial:
        col = self.F.broadcast_scalar(self.F.encode_scalar(c), (self.n,))
        return Polynomial(col.contiguous(), "lagrange")

    def constant_extended(self, c: int) -> Polynomial:
        col = self.F.broadcast_scalar(self.F.encode_scalar(c),
                                      (self.extended_n,))
        return Polynomial(col.contiguous(), "extended")

    def lagrange_from_ints(self, vals) -> Polynomial:
        vals = list(vals)
        if len(vals) != self.n:
            raise ValueError(f"expected {self.n} values, got {len(vals)}")
        return Polynomial(self.F.encode(vals), "lagrange")

    def coeff_from_ints(self, vals) -> Polynomial:
        vals = list(vals)
        if len(vals) > self.n:
            raise ValueError(f"more than {self.n} coefficients")
        vals = vals + [0] * (self.n - len(vals))
        return Polynomial(self.F.encode(vals), "coeff")

    # -- device constants ----------------------------------------------------
    def _zeta_tile(self, z: int, length: int, scale: int = 1):
        """(16, length) tile of scale * [1, z, z^2, 1, z, ...]: the table
        of the into-coset / out-of-coset products, shared by every column
        they are applied to.  Made on the device from its three words at
        each use: at 2^23 a cached tile would hold 512 MiB between
        proofs."""
        pat = to_tensor(ints_to_limbs_np(
            [self.F.to_mont_int(scale * z ** i % P) for i in range(3)]),
            self.device)
        return pat.repeat(1, -(-length // 3))[:, :length].contiguous()

    def _zeta_pattern_n(self):
        return self._zeta_tile(self.g_coset, self.n)

    def _zeta_inv_pattern(self):
        """zeta^{-i mod 3} / extended_n over the quotient's coefficients:
        the 1/extended_n divisor of the inverse transform is folded in
        (domain.py:251-266 of the reference)."""
        return self._zeta_tile(self.g_coset_inv,
                               self.n * self.quotient_poly_degree,
                               scale=self.ntt_ext.n_inv)

    def _t_inv_small(self):
        """t_evaluations^{-1}: one period, 2^(ext_k-k) values (made at each
        use: a domain keeps no device state between proofs)."""
        return to_tensor(ints_to_limbs_np(
            [self.F.to_mont_int(v) for v in self.t_evaluations_inv]),
            self.device)

    # -- transforms ----------------------------------------------------------
    def _expect(self, p: Polynomial, basis: str, length: int):
        if p.basis != basis or len(p) != length:
            raise ValueError(f"expected a {basis} polynomial of length "
                             f"{length}, got {p.basis} of {len(p)}")

    def lagrange_to_coeff(self, p: Polynomial) -> Polynomial:
        self._expect(p, "lagrange", self.n)
        return Polynomial(self.ntt.inverse(p.values), "coeff")

    def coeff_to_lagrange(self, p: Polynomial) -> Polynomial:
        self._expect(p, "coeff", self.n)
        return Polynomial(self.ntt.forward(p.values), "lagrange")

    def coeff_to_extended(self, p: Polynomial) -> Polynomial:
        """distribute_powers_zeta + zero-pad + extended-domain NTT
        (mirrors halo2_proofs/src/poly/domain.rs:270-287)."""
        self._expect(p, "coeff", self.n)
        return Polynomial(self.coeff_to_extended_values(p.values), "extended")

    def coeff_to_extended_values(self, values):
        """(16, *mid, n) coefficient columns -> (16, *mid, extended_n)."""
        box = [torch.zeros(values.shape[:-1] + (self.extended_n,),
                           dtype=torch.int32, device=values.device)]
        box[0][..., : self.n] = cuda_ops.mul_tiled(
            self.F, values.contiguous(), self._zeta_pattern_n())
        return self.ntt_ext.forward(box)        # the padded copy handed over

    def dist_ntt(self, mesh, axis="x", extended: bool = False) -> DistNTT:
        """The cached four-step transform of this domain (or of its
        extended domain) sharded over a mesh axis: the prover's transform
        under params.use_mesh (ntt/distributed.py)."""
        key = (mesh, axis, extended)
        d = self._dist.get(key)
        if d is None:
            d = self._dist[key] = DistNTT(
                self.extended_k if extended else self.k, mesh, axis,
                omega=self.extended_omega if extended else self.omega)
        return d

    def extended_to_coeff(self, p: Polynomial, mesh=None,
                          axis="x") -> torch.Tensor:
        """Extended evals -> quotient coefficients, truncated to
        n * quotient_poly_degree (domain.rs:328-350). Returns raw (16, t).

        CONSUMES p.values (p is left without values), as the reference's
        domain.py:223 does: the extended column is let go inside the
        transform.  With a mesh, p.values is row-sharded (a ShardedArray,
        as the sharded evaluator gives h) and the inverse transform is the
        four-step one over the mesh: each shard folds the divisor and the
        zeta^{-i} pattern into its own rows, and the coefficients are
        gathered on this domain's device.  Else, from extended_n >=
        STREAM_NTT_MIN on, the inverse transform runs in lane chunks
        (NTT.inverse_streamed_nodiv), so its live memory is input + output
        + mid table + one chunk."""
        self._expect(p, "extended", self.extended_n)
        box, p.values = [p.values], None
        tail = self.n * self.quotient_poly_degree
        if mesh is not None:
            return self._extended_to_coeff_dist(box, mesh, axis, tail)
        if self.extended_n >= STREAM_NTT_MIN:
            coeffs = self.ntt_ext.inverse_streamed_nodiv(box)
        else:
            coeffs = self.ntt_ext.inverse_nodiv(box)
        return cuda_ops.mul_tiled(self.F, coeffs[:, :tail].contiguous(),
                                  self._zeta_inv_pattern())

    def _extended_to_coeff_dist(self, box, mesh, axis, tail: int):
        shards = self.dist_ntt(mesh, axis, extended=True).inverse_nodiv(
            box).shards
        L = self.extended_n // len(shards)
        out = []
        for d, s in enumerate(shards):
            rows = min(L, tail - d * L)
            if rows <= 0:
                break
            # the pattern from this shard's first row on: phase d*L mod 3
            phase = d * L % 3
            pat = self._zeta_tile(self.g_coset_inv, phase + rows,
                                  scale=self.ntt_ext.n_inv)[:, phase:]
            out.append(cuda_ops.mul_tiled(fr(s.device),
                                          s[:, :rows].contiguous(),
                                          pat.to(s.device).contiguous()))
        del shards
        return gather(out, self.device)

    def divide_by_vanishing_poly(self, p: Polynomial) -> Polynomial:
        """h / t(X) on the extended coset; row-sharded values (a
        ShardedArray) are divided shard by shard."""
        self._expect(p, "extended", self.extended_n)
        # t_evaluations^{-1} is periodic with period 2^(ext_k - k): the
        # small table serves every period (a shard's ext_n/D rows are a
        # multiple of it while n >= D)
        period = len(self.t_evaluations_inv)
        tab = self._t_inv_small()

        def divide(v):
            return cuda_ops.mul_tiled(
                fr(v.device), v.reshape(N_LIMBS, -1, period).contiguous(),
                tab.to(v.device)).reshape(N_LIMBS, -1)

        if isinstance(p.values, ShardedArray):
            return Polynomial(p.values.map(divide), "extended")
        return Polynomial(divide(p.values), "extended")

    def rotate_extended(self, values, rotation: int):
        """Roll extended-domain values by rotation over the ORIGINAL domain
        (scale factor 2^(ext_k - k)) — domain.rs:305-321."""
        shift = rotation << (self.extended_k - self.k)
        return torch.roll(values, -shift, dims=-1)

    # -- host scalar helpers (verifier / transcript side) ------------------
    def rotate_omega(self, value: int, rotation: int) -> int:
        """value * omega^rotation (host ints)."""
        if rotation >= 0:
            return value * pow(self.omega, rotation, P) % P
        return value * pow(self.omega_inv, -rotation, P) % P

    def l_i_range(self, x: int, xn: int, rotations) -> list:
        """Barycentric Lagrange-basis evaluations l_i(x) for i in rotations
        (domain.rs:497-522)."""
        common = (xn - 1) * self.barycentric_weight % P
        out = []
        for rot in rotations:
            denom = (x - self.rotate_omega(1, rot)) % P
            inv = pow(denom, P - 2, P)
            out.append(self.rotate_omega(inv * common % P, rot))
        return out

    def get_quotient_poly_degree(self) -> int:
        return self.quotient_poly_degree
