"""Permutation (copy-constraint) argument.

Re-design of halo2_proofs/src/plonk/permutation/:
  * keygen (keygen.rs:23-262): union-find cycle assembly on host, sigma
    tables materialized on the device as delta^col * omega^row via two
    gathers + one field mul (no per-cell host big-int math)
  * prover (prover.rs:48-168): per-chunk grand products via device batch
    inversion + blocked prefix-product scan; chunk chaining through last_z;
    u-random blinding tail
  * verifier (verifier.rs:106-205): host-int expression mirror

DELTA = g^{2^S}: generator of the odd-order subgroup, matching ff's DELTA
for bn256 Fr (used for the distinct-coset shifts delta^j).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass

import numpy as np
import torch

from halo2_tpu_torch.fields.bn254 import FR_GENERATOR, FR_MODULUS, FR_S, fr
from halo2_tpu_torch.fields.limbs import (N_LIMBS, ints_to_limbs_np,
                                          to_tensor)
from halo2_tpu_torch.ntt.ntt import powers_table_np
from halo2_tpu_torch.poly.arith import PointPowers, eval_poly

P = FR_MODULUS
DELTA = pow(FR_GENERATOR, 1 << FR_S, P)
# the reference's `sanity-checks` feature: the grand product's closure is
# read back and checked (one scalar from the device a proof)
_SANITY = os.environ.get("HALO2_TPU_SANITY_CHECKS", "") == "1"


class Assembly:
    """Union-find over (column_position, row) cells; becomes the sigma
    mapping (cycle-next permutation)."""

    def __init__(self, columns, n: int):
        self.columns = list(columns)         # permutation columns, in order
        self.col_pos = {c: i for i, c in enumerate(self.columns)}
        self.n = n
        m = len(self.columns)
        self.parent = np.arange(m * n, dtype=np.int64)
        # cells that ever participated in a union: mapping() only needs to
        # walk these — everything else is an identity cycle
        self.touched = set()

    def _find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def copy(self, left_col, left_row: int, right_col, right_row: int):
        try:
            li = self.col_pos[left_col]
            ri = self.col_pos[right_col]
        except KeyError as e:
            raise ValueError(
                f"column {e.args[0]} not enabled for equality") from None
        if not (0 <= left_row < self.n and 0 <= right_row < self.n):
            raise ValueError("copy row out of bounds")
        la, rb = li * self.n + left_row, ri * self.n + right_row
        self.touched.add(la)
        self.touched.add(rb)
        a, b = self._find(la), self._find(rb)
        if a != b:
            self.parent[a] = b

    def mapping(self) -> np.ndarray:
        """(m, n, 2) int32: mapping[i][j] = (col, row) of the NEXT cell in
        the cycle (identity for singletons)."""
        m = len(self.columns)
        # group TOUCHED cells by root, chain each group cyclically; all
        # untouched cells are identity singletons (no find() for them)
        groups: dict[int, list[int]] = {}
        for cell in sorted(self.touched):
            groups.setdefault(self._find(cell), []).append(cell)
        nxt = np.arange(m * self.n, dtype=np.int64)
        for cells in groups.values():
            if len(cells) > 1:
                for i, c in enumerate(cells):
                    nxt[c] = cells[(i + 1) % len(cells)]
        out = np.empty((m, self.n, 2), dtype=np.int32)
        out[:, :, 0] = (nxt // self.n).reshape(m, self.n)
        out[:, :, 1] = (nxt % self.n).reshape(m, self.n)
        return out


@dataclass
class PermutationVk:
    commitments: list  # host affine points, one per permutation column


@dataclass
class PermutationPk:
    """Sigma polynomials, Lagrange and coefficient form: the extended-coset
    form is produced transiently inside the h evaluation."""
    sigmas_lagrange: torch.Tensor   # (16, m, n)
    sigmas_coeff: torch.Tensor      # (16, m, n)


def build_keys(params, domain, assembly: Assembly):
    """Materialize sigma polynomials and their commitments."""
    F = domain.F
    n = domain.n
    m = len(assembly.columns)
    if m == 0:
        return PermutationVk([]), PermutationPk(F.zeros((0, n)),
                                                F.zeros((0, n)))

    mapping = assembly.mapping()
    omega_tab = PointPowers.get(domain.omega, n, domain.device)
    delta_tab = to_tensor(
        powers_table_np(DELTA, max(m, 1), P, F.to_mont_int), domain.device)
    mapcol = torch.from_numpy(mapping[:, :, 0].astype(np.int64)).to(
        domain.device)
    maprow = torch.from_numpy(mapping[:, :, 1].astype(np.int64)).to(
        domain.device)
    d = delta_tab[:, mapcol.reshape(-1)].reshape(N_LIMBS, m, n)
    o = omega_tab[:, maprow.reshape(-1)].reshape(N_LIMBS, m, n)
    sig_lag = F.mul(d, o)

    commitments = params.commit_many_affine(
        [sig_lag[:, i, :] for i in range(m)], base="lagrange")
    sig_coeff = domain.ntt.inverse(sig_lag)
    return PermutationVk(commitments), PermutationPk(sig_lag, sig_coeff)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def _chunk_modified_values(F, values, sigmas, deltaomega, beta, gamma):
    """values/sigmas/deltaomega: (16, C, n); beta/gamma: (16,) Montgomery.
    Returns prod_j (v + delta^j beta omega^i + gamma) / (v + beta sigma + gamma)."""
    denom = F.add(F.add(values, F.mul(sigmas, beta)), gamma)
    # product over the column axis
    C = denom.shape[1]
    dprod = denom[:, 0, :]
    for j in range(1, C):
        dprod = F.mul(dprod, denom[:, j, :])
    dinv = F.batch_inverse(dprod)
    numer = F.add(F.add(values, F.mul(deltaomega, beta)), gamma)
    nprod = numer[:, 0, :]
    for j in range(1, C):
        nprod = F.mul(nprod, numer[:, j, :])
    return F.mul(nprod, dinv)


def _build_z(F, modified, last_z):
    """z[0] = last_z; z[i] = last_z * prod_{k<i} modified_k."""
    pref = F.prefix_mul(modified)  # inclusive
    n = modified.shape[-1]
    excl = torch.cat([F.ones((1,)), pref[:, : n - 1]], dim=1)
    return F.mul(excl, last_z)


def commit_z_polys(params, domain, cs, pkey: PermutationPk, value_cols,
                   beta: int, gamma: int, rng: random.Random):
    """Compute all permutation grand-product columns (Lagrange form, blinded)
    and their commitments.  value_cols: fn(column) -> (16, n) device lagrange.

    Returns (zs_lagrange list, commitments list of host points)."""
    columns = cs.permutation.columns
    if not columns:
        return [], []
    F = domain.F
    chunk_len = cs.degree() - 2
    bf = cs.blinding_factors()
    n = domain.n

    omega_tab = PointPowers.get(domain.omega, n, domain.device)
    beta_l = F.encode_scalar(beta)
    gamma_l = F.encode_scalar(gamma)

    zs = []
    last_z = F.encode_scalar(1)
    for start in range(0, len(columns), chunk_len):
        chunk = columns[start: start + chunk_len]
        vals = torch.stack([value_cols(c) for c in chunk], dim=1)  # (16,C,n)
        sigmas = pkey.sigmas_lagrange[:, start: start + len(chunk), :]
        # deltaomega[j, i] = delta^{start+j} * omega^i
        dpows = [pow(DELTA, start + j, P) for j in range(len(chunk))]
        dtab = to_tensor(ints_to_limbs_np([F.to_mont_int(d) for d in dpows]),
                         domain.device)
        deltaomega = F.mul(dtab[:, :, None], omega_tab[:, None, :])
        modified = _chunk_modified_values(F, vals, sigmas, deltaomega,
                                          beta_l, gamma_l)
        z = _build_z(F, modified, last_z)
        # blinding tail
        blinds = [rng.randrange(P) for _ in range(bf)]
        z[:, n - bf:] = F.encode(blinds)
        last_z = z[:, n - (bf + 1)].clone()
        zs.append(z)
    if _SANITY:
        # the chained grand product must close to 1
        final = F.decode_scalar(last_z)
        if final != 1:
            raise AssertionError(f"permutation grand product != 1: {final}")
    return zs, params.commit_many_affine(zs, base="lagrange")


def evaluate_sets(domain, cs, z_coeffs, x: int):
    """Per-set evals (z(x), z(wx), [z(w^last x) except last set]) in the
    reference transcript order.  Returns list of scalars in write order."""
    bf = cs.blinding_factors()
    x_next = domain.rotate_omega(x, 1)
    x_last = domain.rotate_omega(x, -(bf + 1))
    out = []
    for i, zc in enumerate(z_coeffs):
        out.append(eval_poly(zc, x))
        out.append(eval_poly(zc, x_next))
        if i + 1 < len(z_coeffs):
            out.append(eval_poly(zc, x_last))
    return out


# ---------------------------------------------------------------------------
# Verifier expressions (host ints)
# ---------------------------------------------------------------------------

@dataclass
class SetEvals:
    z_x: int
    z_wx: int
    z_last: int | None


def read_product_commitments(cs, transcript) -> list:
    chunk_len = cs.degree() - 2
    num_sets = (len(cs.permutation.columns) + chunk_len - 1) // chunk_len
    return [transcript.read_point() for _ in range(num_sets)]


def read_set_evals(cs, num_sets: int, transcript) -> list:
    sets = []
    for i in range(num_sets):
        z_x = transcript.read_scalar()
        z_wx = transcript.read_scalar()
        z_last = transcript.read_scalar() if i + 1 < num_sets else None
        sets.append(SetEvals(z_x, z_wx, z_last))
    return sets


def verifier_expressions(cs, sets, common_evals, query_eval, l_0, l_last,
                         l_blind, beta, gamma, x):
    """Host-int mirror of permutation/verifier.rs:106-205.
    query_eval(column) -> eval of that column at x (cur rotation)."""
    if not sets:
        return []
    chunk_len = cs.degree() - 2
    columns = cs.permutation.columns
    out = []
    out.append(l_0 * (1 - sets[0].z_x) % P)
    out.append((sets[-1].z_x * sets[-1].z_x - sets[-1].z_x) % P * l_last % P)
    for i in range(1, len(sets)):
        out.append((sets[i].z_x - sets[i - 1].z_last) % P * l_0 % P)
    active = (1 - (l_last + l_blind)) % P
    for ci, start in enumerate(range(0, len(columns), chunk_len)):
        chunk = columns[start: start + chunk_len]
        s = sets[ci]
        left = s.z_wx
        for j, col in enumerate(chunk):
            left = left * ((query_eval(col) + beta * common_evals[start + j] + gamma) % P) % P
        right = s.z_x
        current_delta = beta * x % P * pow(DELTA, start, P) % P
        for col in chunk:
            right = right * ((query_eval(col) + current_delta + gamma) % P) % P
            current_delta = current_delta * DELTA % P
        out.append((left - right) % P * active % P)
    return out
