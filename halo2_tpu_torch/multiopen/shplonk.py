"""SHPLONK (BDFG20) multiopen.

Mirrors halo2_proofs/src/poly/multiopen/shplonk.rs +
shplonk/{prover,verifier}.rs:
  * commitments grouped by their ROTATION SET; the super point set is the
    union of all opening points (shplonk.rs:57-153)
  * prover: per set, the polys folded by y on the device with their
    low-degree equivalents (host Lagrange interpolation of the evals)
    taken off, divided by the set's vanishing poly (one Kate division a
    point), folded by v -> h1; then the linearisation poly at u and the
    final witness h2 (shplonk/prover.rs:78-234)
  * verifier: two-channel PairMSM with z-difference normalization
    (shplonk/verifier.rs:22-110)

Query identity is object identity (`id`) of the poly / commitment: callers
pass one object per logical commitment (the reference compares pointers
the same way), and two commitments of equal value stay two.
"""

from __future__ import annotations

import torch

from halo2_tpu_torch.fields.bn254 import FR_MODULUS, fr
from halo2_tpu_torch.fields.limbs import ints_to_limbs_np, to_tensor
from halo2_tpu_torch.multiopen.common import HostMSM, PairMSM
from halo2_tpu_torch.poly.arith import (eval_poly, eval_poly_batch,
                                        field_sum, kate_division)

P = FR_MODULUS


def _lagrange_interpolate(points, evals):
    """Host exact interpolation; returns coeff list of len(points)."""
    if len(points) == 1:
        return [evals[0] % P]
    coeffs = [0] * len(points)
    for i, (xi, yi) in enumerate(zip(points, evals)):
        denom = 1
        for j, xj in enumerate(points):
            if j != i:
                denom = denom * (xi - xj) % P
        inv = pow(denom, P - 2, P)
        # numerator poly prod_{j != i} (X - xj)
        num = [1]
        for j, xj in enumerate(points):
            if j != i:
                num = _poly_mul_linear(num, (-xj) % P)
        scale = yi * inv % P
        for k, c in enumerate(num):
            coeffs[k] = (coeffs[k] + c * scale) % P
    return coeffs


def _poly_mul_linear(poly, c0):
    """poly(X) * (X + c0) over host ints."""
    out = [0] * (len(poly) + 1)
    for i, c in enumerate(poly):
        out[i] = (out[i] + c * c0) % P
        out[i + 1] = (out[i + 1] + c) % P
    return out


def _eval_vanishing(roots, u):
    acc = 1
    for r in roots:
        acc = acc * ((u - r) % P) % P
    return acc


def _eval_host(coeffs, u):
    return sum(c * pow(u, k, P) for k, c in enumerate(coeffs)) % P


def _fold(values, chal):
    """Horner fold of host ints: ((v0 c + v1) c + v2) ..."""
    acc = 0
    for v in values:
        acc = (acc * chal + v) % P
    return acc


def _construct_intermediate_sets(queries):
    """Returns (rotation_sets, super_point_set); each rotation set is
    {rotations, points, queries: one query object per commitment}.

    Ordering mirrors the reference: super points by ascending rotation
    (BTreeMap); rotation sets ordered by their sorted rotation tuple;
    within a set, commitments in first-appearance order."""
    rotation_point = {}
    for q in queries:
        if rotation_point.setdefault(q.rotation, q.point) != q.point:
            raise ValueError("queries of one rotation must share their point")
    super_point_set = [rotation_point[r] for r in sorted(rotation_point)]

    com_rotations = []  # [(query, set(rotations))] in first-appearance order
    by_key = {}
    for q in queries:
        key = id(q.commitment) if hasattr(q, "commitment") else id(q.poly)
        if key in by_key:
            by_key[key][1].add(q.rotation)
        else:
            by_key[key] = (q, {q.rotation})
            com_rotations.append(by_key[key])

    set_map = {}  # sorted-rotation-tuple -> [query objects]
    for q, rots in com_rotations:
        set_map.setdefault(tuple(sorted(rots)), []).append(q)

    return [{"rotations": t, "points": [rotation_point[r] for r in t],
             "queries": set_map[t]} for t in sorted(set_map)], \
        super_point_set


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def _weighted_sum(F, stack, weights):
    """sum_i weights[i] * stack[:, i, :] for a (16, Q, n) stack and Q host
    ints: one product launch on the stack and one field sum over Q."""
    w = to_tensor(ints_to_limbs_np([F.to_mont_int(v % P) for v in weights]),
                  stack.device)
    return field_sum(F.mul(stack, w[:, :, None]).transpose(1, 2))


def _sub_low(F, poly, coeffs):
    """poly - c(X) for the few host coefficients of c."""
    m = len(coeffs)
    low = F.sub(poly[:, :m], F.encode(coeffs))
    return torch.cat([low, poly[:, m:]], dim=1)


def create_proof(params, transcript, queries):
    F = fr(params.device)
    y = transcript.squeeze_challenge()
    rotation_sets, super_point_set = _construct_intermediate_sets(queries)
    v = transcript.squeeze_challenge()

    # every (poly, point) value the sets need: the polys of one point
    # through one batched dot
    by_point = {}
    for rs in rotation_sets:
        for pt in rs["points"]:
            polys = by_point.setdefault(pt, {})
            for q in rs["queries"]:
                polys.setdefault(id(q.poly), q.poly)
    evals = {}
    for pt, polys in by_point.items():
        for key, val in zip(polys, eval_poly_batch(list(polys.values()), pt)):
            evals[(key, pt)] = val

    # per set: fold_y of its polys (device), its interpolants r_j (host),
    # and the quotient of fold_y(P_j - r_j) by the set's vanishing poly
    set_data = []
    quotients = []
    for rs in rotation_sets:
        points = rs["points"]
        polys = torch.stack([q.poly for q in rs["queries"]], dim=1)
        Q = polys.shape[1]
        folded = _weighted_sum(F, polys, [pow(y, Q - 1 - i, P)
                                          for i in range(Q)])
        r_coeffs = [_lagrange_interpolate(
            points, [evals[(id(q.poly), pt)] for pt in points])
            for q in rs["queries"]]
        r_fold = [_fold(cs, y) for cs in zip(*r_coeffs)]
        n_x = _sub_low(F, folded, r_fold)
        for pt in points:
            n_x = kate_division(n_x, pt)
        quotients.append(n_x)
        set_data.append((rs, folded, r_coeffs))

    S = len(quotients)
    h_x = _weighted_sum(F, torch.stack(quotients, dim=1),
                        [pow(v, S - 1 - i, P) for i in range(S)])
    del quotients
    transcript.write_point(params.commit_many_affine([h_x])[0])
    u = transcript.squeeze_challenge()

    # l(X) = sum_i v^(S-1-i) z_i (fold_y(P_j) - fold_y(r_j(u))) - Z_T(u) h(X)
    weights, const, z_diffs = [], 0, []
    for i, (rs, _, r_coeffs) in enumerate(set_data):
        diffs = [pt for pt in super_point_set if pt not in rs["points"]]
        z_i = _eval_vanishing(diffs, u)
        z_diffs.append(z_i)
        w = pow(v, S - 1 - i, P) * z_i % P
        weights.append(w)
        const = (const + w * _fold([_eval_host(rc, u) for rc in r_coeffs],
                                   y)) % P
    zt_eval = _eval_vanishing(super_point_set, u)
    l_x = _weighted_sum(F, torch.stack(
        [folded for _, folded, _ in set_data] + [h_x], dim=1),
        weights + [(-zt_eval) % P])
    l_x = _sub_low(F, l_x, [const])
    # the reference asserts l(u) == 0 unconditionally
    # (shplonk/prover.rs:211-215)
    if eval_poly(l_x, u) != 0:
        raise ValueError("SHPLONK linearisation does not vanish at u")
    h2 = F.mul(kate_division(l_x, u),
               F.encode_scalar(pow(z_diffs[0], P - 2, P)))
    transcript.write_point(params.commit_many_affine([h2])[0])


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

def verify_proof(params_verifier, transcript, queries) -> PairMSM:
    rotation_sets, super_point_set = _construct_intermediate_sets(queries)
    # evals per commitment per rotation
    eval_map = {(id(q.commitment), q.rotation): q.eval for q in queries}

    y = transcript.squeeze_challenge()
    v = transcript.squeeze_challenge()
    h1 = transcript.read_point()
    u = transcript.squeeze_challenge()
    h2 = transcript.read_point()

    z_0 = 0
    z_0_diff_inverse = 0
    outer_terms = []
    r_outer_acc = 0
    for i, rs in enumerate(rotation_sets):
        diffs = [pt for pt in super_point_set if pt not in rs["points"]]
        z_diff_i = _eval_vanishing(diffs, u)
        if i == 0:
            z_0 = _eval_vanishing(rs["points"], u)
            z_0_diff_inverse = pow(z_diff_i, P - 2, P)
            z_diff_i = 1
        else:
            z_diff_i = z_diff_i * z_0_diff_inverse % P

        bases = []
        r_inner_acc = 0
        for q in rs["queries"]:
            evals = [eval_map[(id(q.commitment), r)] for r in rs["rotations"]]
            r_eval = _eval_host(_lagrange_interpolate(rs["points"], evals), u)
            r_inner_acc = (y * r_inner_acc + r_eval) % P
            bases.append(q.commitment.eval()
                         if isinstance(q.commitment, HostMSM)
                         else q.commitment)
        r_outer_acc = (v * r_outer_acc + r_inner_acc * z_diff_i) % P

        # the inner commitments with y powers, scaled by z_diff_i
        combined = HostMSM()
        for j, b in enumerate(bases):
            combined.append_term(pow(y, len(bases) - 1 - j, P) * z_diff_i,
                                 b)
        outer_terms.append(combined)

    right = HostMSM()
    for j, m_ in enumerate(outer_terms):
        m_.scale(pow(v, len(outer_terms) - 1 - j, P))
        right.add_msm(m_)
    right.append_term((-r_outer_acc) % P, params_verifier.g1)
    right.append_term((-z_0) % P, h1)
    right.append_term(u, h2)

    left = HostMSM()
    left.append_term(1, h2)
    return PairMSM(left, right)
