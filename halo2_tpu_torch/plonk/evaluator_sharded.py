"""h(X) with the extended domain sharded over a mesh of devices (the port
of the JAX package's plonk/evaluator_sharded.py).

The reference splits the gate monomials across GPUs
(halo2_proofs/src/plonk/evaluation.rs:326-346); the JAX package shards the
extended evaluation DOMAIN (rows) instead, and so does the port: every
device holds a contiguous block of ext_n/D rows of every extended column,
and the constraint fold is row-parallel except for two structured
exchanges:

  * the coset extension of each column — the four-step transform over
    the mesh (ntt/distributed.py), whose middle transpose is an
    all_to_all;
  * rotations — each roll moves only the boundary rows between
    neighbouring shards (utils/mesh.py `dist_roll`, at most two transfers a
    shard).

The constraint body is the single-device engine's own
(plonk/evaluator.py `h_fold_body`), run ONCE over sharded arrays
(utils/mesh.ShardedArray) with a field context whose ops map over the
shards, each on its own device's kernels, and whose rolls are
`dist_roll`.  A shard-by-shard loop over the body could not work: a roll
on shard 0 reads shard 1's column before shard 1 would have computed it.
"""

from __future__ import annotations

import torch

from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.fields.limbs import N_LIMBS
from halo2_tpu_torch.plonk.evaluator import h_fold_body
from halo2_tpu_torch.plonk.expr_eval import ExprCtx
from halo2_tpu_torch.utils import mesh as mesh_mod
from halo2_tpu_torch.utils.mesh import Replicated, ShardedArray


class ShardedField:
    """Fr over row-sharded arrays: add / sub / mul / neg of ShardedArrays
    and Replicated scalars, each shard's op on its own device's Fr
    context (so a CUDA shard launches the field kernel on its card)."""

    def __init__(self, devices):
        self.devices = list(devices)

    def _shard(self, x, d: int):
        if isinstance(x, ShardedArray):
            return x.shards[d]
        if isinstance(x, Replicated):
            return x.on(self.devices[d])
        raise TypeError(f"sharded field op on {type(x).__name__}")

    def _op(self, name: str, a, b):
        if isinstance(a, Replicated) and isinstance(b, Replicated):
            dev = self.devices[0]
            return Replicated(getattr(fr(dev), name)(a.on(dev), b.on(dev)))
        return ShardedArray([
            getattr(fr(dev), name)(self._shard(a, d), self._shard(b, d))
            for d, dev in enumerate(self.devices)])

    def add(self, a, b):
        return self._op("add", a, b)

    def sub(self, a, b):
        return self._op("sub", a, b)

    def mul(self, a, b):
        return self._op("mul", a, b)

    def neg(self, a):
        return ShardedArray([fr(dev).neg(self._shard(a, d))
                             for d, dev in enumerate(self.devices)])

    def encode_scalar(self, x: int) -> Replicated:
        return Replicated(fr(self.devices[0]).encode_scalar(x))

    def broadcast_scalar(self, limbs: Replicated, batch_shape):
        """A scalar broadcast over each shard's `batch_shape` (views)."""
        return ShardedArray([fr(dev).broadcast_scalar(limbs.on(dev),
                                                      batch_shape)
                             for dev in self.devices])

    def ones(self, batch_shape) -> ShardedArray:
        return ShardedArray([fr(dev).ones(batch_shape)
                             for dev in self.devices])

    def zeros(self, batch_shape) -> ShardedArray:
        return ShardedArray([fr(dev).zeros(batch_shape)
                             for dev in self.devices])


class ShardedEvaluator:
    """h(X) for one proving key with the extended domain row-sharded over
    mesh axis `axis`."""

    def __init__(self, pk, mesh, axis: str = "x"):
        self.pk = pk
        self.devices = mesh.devices_of(axis)
        self.D = len(self.devices)
        domain = pk.vk.domain
        self.rot_scale = 1 << (domain.extended_k - domain.k)
        self.ext_n = domain.extended_n
        if self.ext_n % self.D:
            raise ValueError("the extended domain must split evenly over "
                             "the devices")
        self.L = self.ext_n // self.D
        self.dist = domain.dist_ntt(mesh, axis, extended=True)
        self.F = ShardedField(self.devices)
        # coset_x = outer[i // n2] * inner[i % n2] (evaluator.py
        # coset_x_tables_np), the small tables replicated
        self._coset_n2 = 1 << (domain.extended_k // 2)
        self._coset_outer = Replicated(pk.ev._coset_outer)
        self._coset_inner = Replicated(pk.ev._coset_inner)

    # -- the distributed primitives -----------------------------------------
    def _roll(self, col: ShardedArray, shift: int) -> ShardedArray:
        """Global left roll by `shift` extended rows (utils/mesh.dist_roll)."""
        return ShardedArray(mesh_mod.dist_roll(col.shards, self.devices,
                                               shift))

    def _extend_local(self, coeffs) -> ShardedArray:
        """(16, C, n) coefficients, whole on the mesh's first device ->
        the row-sharded extended coset (16, C, ext_n/D) a shard: the zeta
        shift, each shard's columns of the (n1, n2) view of the zero-padded
        column, the four-step transform over the mesh."""
        domain = self.pk.vk.domain
        n_orig = domain.n
        dist = self.dist
        C = coeffs.shape[1]
        if C == 0:
            return self.F.zeros((0, self.L))
        shifted = cuda_ops.mul_tiled(domain.F, coeffs.contiguous(),
                                     domain._zeta_pattern_n())
        n1, n2, L2 = dist.n1, dist.n2, dist.L2
        slices = []
        for d, dev in enumerate(self.devices):
            x_local = torch.zeros((N_LIMBS, C, n1, L2), dtype=torch.int32,
                                  device=dev)
            if n_orig >= n2:
                # the nonzero rows i1 < n_orig / n2 of the view are whole
                R = n_orig // n2
                v = shifted.reshape(N_LIMBS, C, R, n2)
                x_local[:, :, :R] = mesh_mod.to(
                    v[..., d * L2:(d + 1) * L2], dev)
            else:
                # tiny domains: gather the strided entries i1*n2 + i2
                i1 = torch.arange(n1, device=shifted.device)[:, None]
                i2 = torch.arange(L2, device=shifted.device)[None, :] \
                    + d * L2
                flat = i1 * n2 + i2
                valid = flat < n_orig
                g = shifted.index_select(
                    2, torch.where(valid, flat, 0).reshape(-1))
                g = torch.where(valid.reshape(-1), g, 0)
                x_local[:] = mesh_mod.to(g.reshape(N_LIMBS, C, n1, L2), dev)
            slices.append(x_local)
        return ShardedArray(dist.local_forward(slices))

    def _local_coset_x(self) -> ShardedArray:
        """Each shard's rows of coset_x from the factored tables."""
        n2 = self._coset_n2
        out = []
        for d, dev in enumerate(self.devices):
            i = torch.arange(d * self.L, (d + 1) * self.L, device=dev)
            out.append(fr(dev).mul(
                self._coset_outer.on(dev).index_select(1, i // n2),
                self._coset_inner.on(dev).index_select(1, i % n2)))
        return ShardedArray(out)

    # -- the program ----------------------------------------------------------
    def evaluate_h(self, advice_coeff, instance_coeff, perm_zs_coeff,
                   lookup_ms_coeff, lookup_zs_coeff, shuffle_zs_coeff,
                   theta: int, beta: int, gamma: int, y: int,
                   value_init=None) -> ShardedArray:
        """Evaluator.evaluate_h's contract (coefficient stacks whole on the
        mesh's first device); returns the h numerator row-sharded over the
        mesh, ext_n/D rows a device.  value_init: a previous result to
        chain from (the fold across proofs)."""
        pk = self.pk
        cs = pk.vk.cs
        F = self.F
        L = self.L
        bf = cs.blinding_factors()
        ctx = ExprCtx(
            advice=self._extend_local(advice_coeff),
            fixed=self._extend_local(pk.fixed_coeff),
            instance=self._extend_local(instance_coeff),
            rot_scale=self.rot_scale, length=L,
            roll=self._roll, F=F)
        l_ext = self._extend_local(torch.stack(
            [pk.l0_coeff, pk.l_last_coeff, pk.l_blind_coeff], dim=1))
        l0, l_last, l_blind = (l_ext[:, i, :] for i in range(3))
        one = F.ones((L,))
        l_active = F.sub(one, F.add(l_last, l_blind))
        sigmas_ext = self._extend_local(pk.permutation_pk.sigmas_coeff)
        if value_init is None:
            value_init = F.zeros((L,))
        return h_fold_body(
            cs, ctx, F,
            perm_z=self._extend_local(perm_zs_coeff),
            lookup_m=self._extend_local(lookup_ms_coeff),
            lookup_z=self._extend_local(lookup_zs_coeff),
            shuffle_z=self._extend_local(shuffle_zs_coeff),
            l0=l0, l_last=l_last, l_active=l_active,
            coset_x=self._local_coset_x(),
            sigmas=lambda j: sigmas_ext[:, j, :],
            one=one,
            roll_next=lambda a: self._roll(a, self.rot_scale),
            roll_last=lambda a: self._roll(a, -(bf + 1)
                                                * self.rot_scale),
            theta=F.encode_scalar(theta), beta=F.encode_scalar(beta),
            gamma=F.encode_scalar(gamma), y=F.encode_scalar(y),
            value=value_init)
