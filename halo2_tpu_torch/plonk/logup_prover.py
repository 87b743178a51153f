"""Logup prover-side computation: compression, m(X), grand sums.

Mirrors halo2_proofs/src/plonk/logup/prover.rs:
  * theta-compression of inputs/table on the device (Lagrange ctx)
  * m(X) on the device: the table rows and the input rows are grouped by
    value (`torch.unique` over the rows), the input hits of each value are
    counted and credited to the value's first table row (the reference
    sorts + binary-searches on the CPU, prover.rs:117-179)
  * grand sums z via one batch inversion + blocked prefix sums
    (prover.rs:243-415), chunk chaining through last_z, u16 blinding on m
    and full-width blinding on z
"""

from __future__ import annotations

import os

import numpy as np
import torch

from halo2_tpu_torch.fields.bn254 import FR_MODULUS, fr
from halo2_tpu_torch.fields.limbs import N_LIMBS
from halo2_tpu_torch.plonk.expr_eval import ExprCtx, compress_exprs
from halo2_tpu_torch.poly.arith import prefix_sum

P = FR_MODULUS
# the reference's `sanity-checks` feature: the grand sum's closure is read
# back and checked (one scalar from the device a lookup)
_SANITY = os.environ.get("HALO2_TPU_SANITY_CHECKS", "") == "1"


def compress(argument, lag_ctx: ExprCtx, theta):
    """Returns (table (16, n), input_sets: list of list of (16, n))."""
    table = compress_exprs(argument.table_expressions, lag_ctx, theta)
    sets = [[compress_exprs(inputs, lag_ctx, theta) for inputs in s]
            for s in argument.input_expressions_sets]
    return table, sets


def _value_rows(limbs):
    """(16, N) limbs -> (N, 4) int64 rows, four 16-bit limbs a word: equal
    field elements give equal rows (Montgomery form is a bijection, so no
    conversion is needed to compare)."""
    x = limbs.to(torch.int64)
    words = [x[4 * j] | (x[4 * j + 1] << 16) | (x[4 * j + 2] << 32)
             | (x[4 * j + 3] << 48) for j in range(N_LIMBS // 4)]
    return torch.stack(words, dim=1)


def multiplicity_counts(table, inputs):
    """Hits of the inputs (16, M) on the table (16, u), both in one form.

    Returns (counts (u,) int64, ok, max_count): every hit of a value is
    credited to the value's FIRST table row (later equal rows get 0); ok is
    False when some input value is missing from the table."""
    u = table.shape[-1]
    rows = _value_rows(torch.cat([table, inputs], dim=-1))
    _, group = torch.unique(rows, dim=0, return_inverse=True)
    n_groups = int(group.max()) + 1 if group.numel() else 0
    t_group, i_group = group[:u], group[u:]
    first = torch.full((n_groups,), u, dtype=torch.int64, device=group.device)
    first.scatter_reduce_(0, t_group, torch.arange(u, device=group.device),
                          reduce="amin")
    hits = torch.bincount(i_group, minlength=n_groups)
    ok = bool((first[i_group] < u).all())
    is_first = first[t_group] == torch.arange(u, device=group.device)
    counts = torch.where(is_first, hits[t_group], torch.zeros_like(t_group))
    max_count = int(counts.max()) if u else 0
    return counts, ok, max_count


def multiplicities(table, input_cols, usable_rows: int, rng):
    """m(X): count input hits against the table (first-match representative
    row).  Returns (m_lagrange (16, n) Montgomery with a u16 blinding tail,
    m_max_bits: the bit length of the largest count)."""
    F = fr(table.device)
    n = table.shape[-1]
    inputs = torch.cat([c[:, :usable_rows] for c in input_cols], dim=-1)
    counts, ok, max_count = multiplicity_counts(table[:, :usable_rows],
                                                inputs)
    if not ok:
        raise ValueError("lookup input value not present in table")
    m_max_bits = max(max_count.bit_length(), 1)
    # blinding tail (u16 randoms, prover.rs:208-224) appended in standard
    # form, then ONE to_mont pass for the whole column
    tail = np.array([rng.randrange(1 << 16) for _ in range(n - usable_rows)],
                    dtype=np.int64)
    low = torch.cat([counts, torch.from_numpy(tail).to(table.device)])
    m_std = F.zeros((n,))
    m_std[0] = (low & 0xFFFF).to(torch.int32)
    m_std[1] = (low >> 16).to(torch.int32)
    return F.to_mont(m_std), m_max_bits


def _sum_inverses(F, inv):
    """(16, C, n) -> the sum over C, (16, n)."""
    gs = inv[:, 0, :]
    for i in range(1, inv.shape[1]):
        gs = F.add(gs, inv[:, i, :])
    return gs


def grand_sum_base(F, inputs, table, m, beta):
    """inputs: (16, C, n); returns gs = sum_i 1/(f_i+b) - m/(t+b), (16, n)."""
    C, n = inputs.shape[1], inputs.shape[2]
    phi = F.add(inputs, beta)                           # (16, C, n)
    tau = F.add(table, beta)
    inv = F.batch_inverse(torch.cat([phi.reshape(N_LIMBS, C * n), tau],
                                    dim=-1))
    gs = _sum_inverses(F, inv[:, : C * n].reshape(N_LIMBS, C, n))
    return F.sub(gs, F.mul(m, inv[:, C * n:]))


def grand_sum_extra(F, inputs, beta):
    """inputs: (16, C, n); returns gs = sum_i 1/(f_i+b), (16, n)."""
    C, n = inputs.shape[1], inputs.shape[2]
    phi = F.add(inputs, beta)
    inv = F.batch_inverse(phi.reshape(N_LIMBS, C * n))
    return _sum_inverses(F, inv.reshape(N_LIMBS, C, n))


def z_from_gs(F, gs, last_z):
    """z[0] = last_z; z[i] = last_z + sum_{k<i} gs[k]."""
    pref = prefix_sum(gs)
    n = gs.shape[-1]
    excl = torch.cat([F.zeros((1,)), pref[:, : n - 1]], dim=1)
    return F.add(excl, last_z)


def commit_zs(domain, cs, table, input_sets, m_lagrange, beta: int, rng):
    """Grand-sum columns for one lookup argument (Lagrange, blinded), one
    a set, chained through the value at the last usable row.  Returns a
    list of (16, n) z columns; the caller commits them."""
    F = domain.F
    n = domain.n
    bf = cs.blinding_factors()
    u = n - (bf + 1)
    beta_l = F.encode_scalar(beta)
    zs = []
    last_z = F.zeros(())
    for si, s in enumerate(input_sets):
        inputs = torch.stack(s, dim=1)
        if si == 0:
            gs = grand_sum_base(F, inputs, table, m_lagrange, beta_l)
        else:
            gs = grand_sum_extra(F, inputs, beta_l)
        z = z_from_gs(F, gs, last_z)
        last_z = z[:, u].clone()
        z[:, n - bf:] = F.encode([rng.randrange(P) for _ in range(bf)])
        zs.append(z)
    if _SANITY:
        # the grand sum must telescope to zero across all sets
        # (logup/prover.rs:348-412 sanity-checks feature)
        final = F.decode_scalar(last_z)
        if final != 0:
            raise AssertionError(f"logup grand sum != 0: {final}")
    return zs
