"""h(X) evaluation engine — the quotient-numerator on the extended coset.

Re-design of the reference's dominant phase
(halo2_proofs/src/plonk/evaluation.rs:777-1226 CPU, evaluation_gpu.rs GPU):
  * every referenced column's extended-coset form is produced by the batched
    four-step NTT (one call for all columns of a kind) — each unit is
    materialized exactly once;
  * rotations are `torch.roll` by rot << (ext_k - k) (get_rotation_idx,
    evaluation.rs:40-42);
  * every node of a constraint is one launch of the field kernel over the
    extended domain.

The y-fold order matches the verifier exactly: gates, then permutation
terms (evaluation.rs:1004-1086) — verifier.rs:300-384.  Lookup, shuffle
and range-check terms are not ported yet: a constraint system that has any
is refused.
"""

from __future__ import annotations

import torch

from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.fields.limbs import N_LIMBS, to_tensor
from halo2_tpu_torch.ntt.ntt import powers_table_np
from halo2_tpu_torch.plonk import permutation as perm_mod
from halo2_tpu_torch.plonk.expr_eval import ExprCtx, eval_expr

P = FR_MODULUS


def refuse_unported_arguments(cs):
    """Raise for a constraint system with an argument this package does not
    prove yet, naming it."""
    for name, present in (("lookup", cs.lookups), ("shuffle", cs.shuffles),
                          ("range check", cs.range_check)):
        if present:
            raise NotImplementedError(
                f"the {name} argument is not ported to halo2_tpu_torch yet")


def h_fold_body(cs, ctx, F, *, perm_z, l0, l_last, l_active, coset_x, sigmas,
                one, roll_next, roll_last, beta, gamma, y, value):
    """The constraint y-fold: gates, then the permutation argument.

    All column arrays are (16, C, L); `roll_next`/`roll_last` implement the
    two rotation offsets; expression rotations go through ctx.  Order
    matches verifier.rs."""
    refuse_unported_arguments(cs)

    def ymul(v, t):
        return F.add(F.mul(v, y), t)

    # ---- gates -----------------------------------------------------
    for gate in cs.gates:
        for poly in gate.polys:
            value = ymul(value, eval_expr(poly, ctx))

    # ---- permutation (evaluation.rs:1004-1086) ---------------------
    columns = cs.permutation.columns
    if columns:
        num_sets = perm_z.shape[1]
        chunk_len = cs.degree() - 2
        z = [perm_z[:, i, :] for i in range(num_sets)]
        z_next = [roll_next(zi) for zi in z]
        z_lastrot = [roll_last(zi) for zi in z]

        value = ymul(value, F.mul(F.sub(one, z[0]), l0))
        value = ymul(value, F.mul(F.sub(F.mul(z[-1], z[-1]), z[-1]), l_last))
        for i in range(1, num_sets):
            value = ymul(value, F.mul(F.sub(z[i], z_lastrot[i - 1]), l0))

        def col_ext(column):
            return {"advice": ctx.advice, "fixed": ctx.fixed,
                    "instance": ctx.instance}[column.ctype][:, column.index, :]

        beta_x = F.mul(coset_x, beta)
        for ci, start in enumerate(range(0, len(columns), chunk_len)):
            chunk = columns[start: start + chunk_len]
            left = z_next[ci]
            for j, col in enumerate(chunk):
                sig = sigmas(start + j)
                left = F.mul(left, F.add(F.add(col_ext(col),
                                               F.mul(sig, beta)), gamma))
            right = z[ci]
            for j, col in enumerate(chunk):
                dlimb = F.encode_scalar(pow(perm_mod.DELTA, start + j, P))
                cur_delta = F.mul(beta_x, dlimb)
                right = F.mul(right, F.add(F.add(col_ext(col), cur_delta),
                                           gamma))
            value = ymul(value, F.mul(F.sub(left, right), l_active))

    return value


def coset_x_tables_np(domain):
    """coset_x[i] = zeta * extended_omega^i factored as outer[a] * inner[b]
    with i = a * n2 + b: two sqrt(ext_n)-sized host tables instead of
    ext_n big-int products on the host."""
    ext_n = domain.extended_n
    n2 = 1 << (domain.extended_k // 2)
    n1 = ext_n // n2
    w = domain.extended_omega
    to_mont = domain.F.to_mont_int
    outer = powers_table_np(pow(w, n2, P), n1, P,
                            lambda v: to_mont(v * domain.g_coset % P))
    inner = powers_table_np(w, n2, P, to_mont)
    return outer, inner, n1, n2


class Evaluator:
    """h(X) evaluation for one proving key.

    Memory discipline: the pk stores only coeff-form polys; every extended
    coset (advice, fixed, sigma, z, l0/l_last/l_blind) is produced
    TRANSIENTLY here by the batched coset-extension NTT — the reference
    cuda path's do_extended_fft-per-unit behavior."""

    def __init__(self, pk):
        self.pk = pk
        domain = pk.vk.domain
        self.rot_scale = 1 << (domain.extended_k - domain.k)
        outer, inner, _, _ = coset_x_tables_np(domain)
        self._coset_outer = to_tensor(outer, domain.device)
        self._coset_inner = to_tensor(inner, domain.device)

    def evaluate_h(self, advice_coeff, instance_coeff, perm_zs_coeff,
                   beta: int, gamma: int, y: int, value_init=None):
        """Returns h numerator on the extended coset (16, ext_n)."""
        pk = self.pk
        cs = pk.vk.cs
        domain = pk.vk.domain
        F = domain.F
        ext_n = domain.extended_n
        refuse_unported_arguments(cs)

        def extend_batch(coeffs):
            # (16, C, n) -> (16, C, ext_n)
            if coeffs.shape[1] == 0:
                return F.zeros((0, ext_n))
            return domain.coeff_to_extended_values(coeffs)

        ctx = ExprCtx(
            advice=extend_batch(advice_coeff),
            fixed=extend_batch(pk.fixed_coeff),
            instance=extend_batch(instance_coeff),
            rot_scale=self.rot_scale,
            length=ext_n,
        )
        bf = cs.blinding_factors()

        l_ext = extend_batch(torch.stack(
            [pk.l0_coeff, pk.l_last_coeff, pk.l_blind_coeff], dim=1))
        l0, l_last, l_blind = (l_ext[:, i, :] for i in range(3))
        one = F.ones((ext_n,))
        l_active = F.sub(one, F.add(l_last, l_blind))
        sigmas_ext = extend_batch(pk.permutation_pk.sigmas_coeff)
        coset_x = F.mul(self._coset_outer[:, :, None],
                        self._coset_inner[:, None, :]).reshape(N_LIMBS, ext_n)
        if value_init is None:
            value_init = F.zeros((ext_n,))

        return h_fold_body(
            cs, ctx, F,
            perm_z=extend_batch(perm_zs_coeff),
            l0=l0, l_last=l_last, l_active=l_active,
            coset_x=coset_x,
            sigmas=lambda j: sigmas_ext[:, j, :],
            one=one,
            roll_next=lambda a: torch.roll(a, -self.rot_scale, dims=-1),
            roll_last=lambda a: torch.roll(a, (bf + 1) * self.rot_scale,
                                           dims=-1),
            beta=F.encode_scalar(beta), gamma=F.encode_scalar(gamma),
            y=F.encode_scalar(y), value=value_init)
