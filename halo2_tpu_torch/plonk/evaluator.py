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
terms (evaluation.rs:1004-1086), then lookups (evaluation.rs:1088-1184),
then shuffles (evaluation.rs:1186-1222) — verifier.rs:300-384.  A range
check is a gate and a shuffle of the constraint system, so it needs no
terms of its own.
"""

from __future__ import annotations

import torch

from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.fields.limbs import N_LIMBS, to_tensor
from halo2_tpu_torch.ntt.ntt import powers_table_np
from halo2_tpu_torch.plonk import permutation as perm_mod
from halo2_tpu_torch.plonk.expr_eval import ExprCtx, compress_exprs, eval_expr

P = FR_MODULUS


def h_fold_body(cs, ctx, F, *, perm_z, lookup_m, lookup_z, shuffle_z, l0,
                l_last, l_active, coset_x, sigmas, one, roll_next, roll_last,
                theta, beta, gamma, y, value):
    """The constraint y-fold: gates, the permutation, the logup lookups,
    the shuffles.

    All column arrays are (16, C, L); `lookup_z` holds the z of every set
    of every lookup, lookup by lookup; `roll_next`/`roll_last` implement
    the two rotation offsets; expression rotations go through ctx.  Order
    matches verifier.rs."""

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

    # ---- logup lookups (evaluation.rs:1088-1184) -------------------
    def phi_products(input_set):
        """(prod_i phi_i, sum_i prod_{j != i} phi_j) of one input set."""
        phis = [F.add(compress_exprs(inputs, ctx, theta), beta)
                for inputs in input_set]
        prod = phis[0]
        for p_ in phis[1:]:
            prod = F.mul(prod, p_)
        psum = None
        for i in range(len(phis)):
            term = None
            for j, p_ in enumerate(phis):
                if j != i:
                    term = p_ if term is None else F.mul(term, p_)
            if term is None:
                term = one
            psum = term if psum is None else F.add(psum, term)
        return prod, psum

    z_off = 0
    for li, lookup in enumerate(cs.lookups):
        sets = lookup.input_expressions_sets
        zs = [lookup_z[:, z_off + i, :] for i in range(len(sets))]
        z_off += len(sets)
        tau = F.add(compress_exprs(lookup.table_expressions, ctx, theta), beta)
        # l_0 * z_first ; l_last * z_last
        value = ymul(value, F.mul(zs[0], l0))
        value = ymul(value, F.mul(zs[-1], l_last))
        # base set: ((z(gX)-z(X)) * tau + m) * prod(phi) - tau * sum_prods
        prod0, psum0 = phi_products(sets[0])
        dz = F.sub(roll_next(zs[0]), zs[0])
        term = F.sub(F.mul(F.add(F.mul(dz, tau), lookup_m[:, li, :]), prod0),
                     F.mul(tau, psum0))
        value = ymul(value, F.mul(term, l_active))
        # chaining
        for i in range(1, len(sets)):
            value = ymul(value, F.mul(F.sub(zs[i], roll_last(zs[i - 1])), l0))
        # extra sets
        for i in range(1, len(sets)):
            prod_i, psum_i = phi_products(sets[i])
            dz = F.sub(roll_next(zs[i]), zs[i])
            value = ymul(value, F.mul(F.sub(F.mul(dz, prod_i), psum_i),
                                      l_active))

    # ---- shuffles (evaluation.rs:1186-1222) ------------------------
    for gi, group in enumerate(cs.shuffles):
        z = shuffle_z[:, gi, :]
        # challenges beta^(i+1) per unit
        input_prod, shuf_prod = None, None
        chal = beta
        for unit in group.units:
            a_c = F.add(compress_exprs(unit.input_expressions, ctx, theta),
                        chal)
            s_c = F.add(compress_exprs(unit.shuffle_expressions, ctx, theta),
                        chal)
            input_prod = a_c if input_prod is None else F.mul(input_prod, a_c)
            shuf_prod = s_c if shuf_prod is None else F.mul(shuf_prod, s_c)
            chal = F.mul(chal, beta)
        value = ymul(value, F.mul(F.sub(one, z), l0))
        value = ymul(value, F.mul(F.sub(F.mul(z, z), z), l_last))
        term = F.sub(F.mul(roll_next(z), shuf_prod), F.mul(z, input_prod))
        value = ymul(value, F.mul(term, l_active))

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
                   lookup_ms_coeff, lookup_zs_coeff, shuffle_zs_coeff,
                   theta: int, beta: int, gamma: int, y: int,
                   value_init=None):
        """Returns h numerator on the extended coset (16, ext_n).  The z
        and m arguments are (16, C, n) coefficient stacks; lookup_zs_coeff
        holds every set of every lookup, lookup by lookup."""
        pk = self.pk
        cs = pk.vk.cs
        domain = pk.vk.domain
        F = domain.F
        ext_n = domain.extended_n

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
            lookup_m=extend_batch(lookup_ms_coeff),
            lookup_z=extend_batch(lookup_zs_coeff),
            shuffle_z=extend_batch(shuffle_zs_coeff),
            l0=l0, l_last=l_last, l_active=l_active,
            coset_x=coset_x,
            sigmas=lambda j: sigmas_ext[:, j, :],
            one=one,
            roll_next=lambda a: torch.roll(a, -self.rot_scale, dims=-1),
            roll_last=lambda a: torch.roll(a, (bf + 1) * self.rot_scale,
                                           dims=-1),
            theta=F.encode_scalar(theta), beta=F.encode_scalar(beta),
            gamma=F.encode_scalar(gamma),
            y=F.encode_scalar(y), value=value_init)
