"""A designated halo2 verifier in plain Python: it knows the setup's secret
s, so the final KZG pairing check e(L, [s]G2) == e(R, G2) becomes the check
s * L == R in G1, one multi-scalar multiplication on the host.

It reads a proof of one or several instances of one circuit in the
transcript order of the reference fork's plonk/verifier.rs (instance,
advice, theta, lookup m, beta, gamma, permutation / logup / shuffle
products, vanishing random, y, h pieces, x, the evaluations), rebuilds the
constraint value at x from the circuit's pinned constraint system (gates,
permutation, logup, shuffle), and checks every opening with the GWC or the
SHPLONK multiopen.  The verifying key is the reference's own: commitments
it made from the circuit's columns and s, hashed with the pinned text.

A commitment is a list of (scalar, point) terms, so the h pieces' fold
stays a sum of terms until the last check."""

from __future__ import annotations

import hashlib

from benchmark.reference import bn254
from benchmark.reference.bn254 import R
from benchmark.reference.cs import ConstraintSystem, evaluate
from benchmark.reference.transcript import Reader


def vk_hash(cs: ConstraintSystem, k: int, extended_k: int, fixed: list,
            sigmas: list) -> int:
    """The verifying key's transcript scalar: Blake2b-512 ("Halo2-Verify-
    Key") of the length and the Rust Debug text of the pinned key."""
    def fe(v):
        return f"0x{v:064x}"

    def pt(p):
        return "Infinity" if p is None else f"({fe(p[0])}, {fe(p[1])})"
    text = ("PinnedVerificationKey { "
            f"base_modulus: \"{fe(bn254.Q)}\", "
            f"scalar_modulus: \"{fe(R)}\", "
            f"domain: PinnedEvaluationDomain {{ k: {k}, extended_k: "
            f"{extended_k}, omega: {fe(bn254.omega(k))} }}, "
            f"cs: \"{cs.text}\", "
            f"fixed_commitments: [{', '.join(pt(p) for p in fixed)}], "
            "permutation: VerifyingKey { commitments: "
            f"[{', '.join(pt(p) for p in sigmas)}] }} }}")
    h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
    raw = text.encode()
    h.update(len(raw).to_bytes(8, "little"))
    h.update(raw)
    return int.from_bytes(h.digest(), "little") % R


class Key:
    """What the verifier knows of the circuit: its constraint system, its
    degree, k, the commitments of its fixed and permutation columns (made
    by the reference) and s."""

    def __init__(self, cs: ConstraintSystem, degree: int, k: int, fixed: list,
                 sigmas: list, s: int):
        self.cs, self.degree, self.k, self.s = cs, degree, k, s
        self.n = 1 << k
        self.omega = bn254.omega(k)
        self.quotient_degree = max(degree - 1, 1)
        extended_k = k
        while (1 << extended_k) < self.n * self.quotient_degree:
            extended_k += 1
        self.fixed, self.sigmas = fixed, sigmas
        self.hash = vk_hash(cs, k, extended_k, fixed, sigmas)

    def rotate(self, x: int, rot: int) -> int:
        return x * pow(self.omega, rot % self.n, R) % R


def _term(p):
    return [(1, p)]


def _scaled(terms, f):
    return [(s * f % R, p) for s, p in terms]


def _rotation_groups(queries):
    """GWC's groups: the queries of each rotation, rotations ascending."""
    groups = {}
    for q in queries:
        groups.setdefault(q[1], []).append(q)
    return [groups[r] for r in sorted(groups)]


def _gwc(reader, queries):
    """(left, right) of GWC: sum u^i W_i and sum u^i (z_i W_i + sum v^j C_ij)
    - (sum u^i sum v^j e_ij) G."""
    v = reader.challenge()
    u = reader.challenge()
    left, right, evals = [], [], 0
    for group in _rotation_groups(queries):
        z = group[0][0]
        w = reader.point()
        left = _scaled(left, u) + [(1, w)]
        right = _scaled(right, u) + [(z, w)]
        batch, ebatch = [], 0
        for point, _, com, ev in group:
            if point != z:
                raise ValueError("queries of one rotation at two points")
            batch = _scaled(batch, v) + com
            ebatch = (ebatch * v + ev) % R
        right += batch
        evals = (evals * u + ebatch) % R
    return left, right + [((-evals) % R, bn254.G1)]


def _interpolate_at(points, evals, u):
    """The polynomial through (points, evals), evaluated at u."""
    acc = 0
    for i, (xi, yi) in enumerate(zip(points, evals)):
        num, den = 1, 1
        for j, xj in enumerate(points):
            if j != i:
                num = num * (u - xj) % R
                den = den * (xi - xj) % R
        acc = (acc + yi * num * bn254.inv(den)) % R
    return acc


def _vanishing(roots, u):
    acc = 1
    for r in roots:
        acc = acc * (u - r) % R
    return acc


def _shplonk(reader, queries):
    """(left, right) of SHPLONK (BDFG20): the commitments grouped by the set
    of rotations at which each is opened, sets ordered by their rotations,
    commitments in first-appearance order."""
    point_of = {}
    for point, rot, _, _ in queries:
        if point_of.setdefault(rot, point) != point:
            raise ValueError("queries of one rotation at two points")
    super_points = [point_of[r] for r in sorted(point_of)]
    order, rots, coms, evals = [], {}, {}, {}
    for point, rot, com, ev in queries:
        key = id(com)
        if key not in rots:
            order.append(key)
            rots[key], coms[key] = set(), com
        rots[key].add(rot)
        evals[(key, rot)] = ev
    sets = {}
    for key in order:
        sets.setdefault(tuple(sorted(rots[key])), []).append(key)

    y = reader.challenge()
    v = reader.challenge()
    h1 = reader.point()
    u = reader.challenge()
    h2 = reader.point()

    right, r_outer, z0, z0_diff_inv = [], 0, 0, 0
    for i, rset in enumerate(sorted(sets)):
        points = [point_of[r] for r in rset]
        z_diff = _vanishing([p for p in super_points if p not in points], u)
        if i == 0:
            z0 = _vanishing(points, u)
            z0_diff_inv = bn254.inv(z_diff)
            z_diff = 1
        else:
            z_diff = z_diff * z0_diff_inv % R
        keys = sets[rset]
        r_inner, inner = 0, []
        for j, key in enumerate(keys):
            r_inner = (y * r_inner + _interpolate_at(
                points, [evals[(key, r)] for r in rset], u)) % R
            inner += _scaled(coms[key], pow(y, len(keys) - 1 - j, R) * z_diff)
        r_outer = (v * r_outer + r_inner * z_diff) % R
        right = _scaled(right, v) + inner
    right += [((-r_outer) % R, bn254.G1), ((-z0) % R, h1), (u, h2)]
    return [(1, h2)], right


def verify(key: Key, instances_list: list, proof: bytes, gwc: bool,
           instance_commitments: list) -> tuple[bool, list, str]:
    """(accepted, the advice commitments read, the reason for a
    rejection).  instances_list: per instance of the circuit, its instance
    columns; instance_commitments: per instance, the commitment of each
    column (the verifier's own)."""
    try:
        return _verify(key, instances_list, proof, gwc, instance_commitments)
    except ValueError as err:
        return False, [], f"malformed: {err}"


def _verify(key, instances_list, proof, gwc, instance_commitments):
    cs = key.cs
    n = key.n
    bf = cs.blinding_factors()
    proofs = range(len(instances_list))
    t = Reader(proof)
    t.common_scalar(key.hash)
    for coms in instance_commitments:
        for com in coms:
            t.common_point(com)
    advice = [[t.point() for _ in range(cs.num_advice)] for _ in proofs]
    theta = t.challenge()
    m_coms = [[t.point() for _ in cs.lookups] for _ in proofs]
    beta = t.challenge()
    gamma = t.challenge()
    chunk = key.degree - 2
    n_perm_sets = -(-len(cs.permutation) // chunk) if cs.permutation else 0
    perm_coms = [[t.point() for _ in range(n_perm_sets)] for _ in proofs]
    lookup_coms = [[[t.point() for _ in sets] for sets, _ in cs.lookups]
                   for _ in proofs]
    shuffle_coms = [[t.point() for _ in cs.shuffles] for _ in proofs]
    random_com = t.point()
    y = t.challenge()
    h_coms = [t.point() for _ in range(key.quotient_degree)]
    x = t.challenge()

    inst_ev = [[t.scalar() for _ in cs.instance_queries] for _ in proofs]
    adv_ev = [[t.scalar() for _ in cs.advice_queries] for _ in proofs]
    fixed_ev = [t.scalar() for _ in cs.fixed_queries]
    random_ev = t.scalar()
    sigma_ev = [t.scalar() for _ in cs.permutation]

    def chain(count):
        """(z(x), z(wx), z(w^-(bf+1) x) or None for the last) per set."""
        out = []
        for i in range(count):
            zx, zwx = t.scalar(), t.scalar()
            out.append((zx, zwx, t.scalar() if i + 1 < count else None))
        return out
    perm_ev = [chain(n_perm_sets) for _ in proofs]
    lookup_ev = []
    for _ in proofs:
        per = []
        for sets, _ in cs.lookups:
            m = t.scalar()
            per.append((m, chain(len(sets))))
        lookup_ev.append(per)
    shuffle_ev = [[(t.scalar(), t.scalar()) for _ in cs.shuffles]
                  for _ in proofs]

    # the constraint value at x
    xn = pow(x, n, R)
    common = (xn - 1) * bn254.inv(n) % R

    def lagrange(rot):
        w = key.rotate(1, rot)
        return w * common % R * bn254.inv(x - w) % R
    l_last = lagrange(-(bf + 1))
    l_blind = sum(lagrange(-i) for i in range(1, bf + 1)) % R
    l_0 = lagrange(0)
    active = (1 - l_last - l_blind) % R

    values = []
    for p in proofs:
        def ev(e, p=p):
            return evaluate(e, fixed_ev, adv_ev[p], inst_ev[p])

        values += [ev(g) for g in cs.gates]

        def column_at_x(kind, col, p=p):
            qi = cs.query_index(kind, col)
            return {"advice": adv_ev[p], "fixed": fixed_ev,
                    "instance": inst_ev[p]}[kind][qi]
        sets = perm_ev[p]
        if sets:
            values.append(l_0 * (1 - sets[0][0]) % R)
            values.append((sets[-1][0] ** 2 - sets[-1][0]) * l_last % R)
            for i in range(1, len(sets)):
                values.append((sets[i][0] - sets[i - 1][2]) * l_0 % R)
            for ci, start in enumerate(range(0, len(cs.permutation), chunk)):
                cols = cs.permutation[start:start + chunk]
                left, right = sets[ci][1], sets[ci][0]
                delta = beta * x * pow(bn254.DELTA, start, R) % R
                for j, (kind, col) in enumerate(cols):
                    val = column_at_x(kind, col)
                    left = left * (val + beta * sigma_ev[start + j] + gamma) % R
                    right = right * (val + delta + gamma) % R
                    delta = delta * bn254.DELTA % R
                values.append((left - right) * active % R)

        def compress(exprs):
            acc = 0
            for e in exprs:
                acc = (acc * theta + ev(e)) % R
            return acc

        def phi(input_set):
            terms = [(compress(inputs) + beta) % R for inputs in input_set]
            prod = 1
            for f in terms:
                prod = prod * f % R
            return prod, sum(bn254.inv(f) for f in terms) % R

        for (sets_e, table), (m, zs) in zip(cs.lookups, lookup_ev[p]):
            values.append(l_0 * zs[0][0] % R)
            values.append(l_last * zs[-1][0] % R)
            prod, inv_sum = phi(sets_e[0])
            tau = (compress(table) + beta) % R
            left = (tau * (zs[0][1] - zs[0][0]) + m) * prod % R
            values.append((left - tau * prod * inv_sum) * active % R)
            for i in range(1, len(sets_e)):
                values.append(l_0 * (zs[i][0] - zs[i - 1][2]) % R)
            for i in range(1, len(sets_e)):
                prod, inv_sum = phi(sets_e[i])
                values.append((zs[i][1] - zs[i][0] - inv_sum) * prod
                              * active % R)

        for units, (zx, zwx) in zip(cs.shuffles, shuffle_ev[p]):
            prod_sh, prod_in, chal = 1, 1, beta
            for ins, shs in units:
                prod_sh = prod_sh * (compress(shs) + chal) % R
                prod_in = prod_in * (compress(ins) + chal) % R
                chal = chal * beta % R
            values.append(l_0 * (1 - zx) % R)
            values.append(l_last * (zx * zx - zx) % R)
            values.append((zwx * prod_sh - zx * prod_in) * active % R)

    h_eval = 0
    for val in values:
        h_eval = (h_eval * y + val) % R
    h_eval = h_eval * bn254.inv(xn - 1) % R
    h_msm = []
    for com in reversed(h_coms):
        h_msm = _scaled(h_msm, xn) + [(1, com)]

    # the queries, in the verifier's order: (point, rotation, commitment
    # terms, evaluation); one list object per commitment
    x_next = key.rotate(x, 1)
    x_last = key.rotate(x, -(bf + 1))
    queries = []

    def z_chain(coms, evs):
        for i, (zx, zwx, _) in enumerate(evs):
            queries.append((x, 0, coms[i], zx))
            queries.append((x_next, 1, coms[i], zwx))
        for i in range(len(evs) - 2, -1, -1):
            queries.append((x_last, -(bf + 1), coms[i], evs[i][2]))

    for p in proofs:
        inst = [_term(c) for c in instance_commitments[p]]
        adv = [_term(c) for c in advice[p]]
        for qi, (col, rot) in enumerate(cs.instance_queries):
            queries.append((key.rotate(x, rot), rot, inst[col], inst_ev[p][qi]))
        for qi, (col, rot) in enumerate(cs.advice_queries):
            queries.append((key.rotate(x, rot), rot, adv[col], adv_ev[p][qi]))
        z_chain([_term(c) for c in perm_coms[p]], perm_ev[p])
        for li, (m, zs) in enumerate(lookup_ev[p]):
            queries.append((x, 0, _term(m_coms[p][li]), m))
            z_chain([_term(c) for c in lookup_coms[p][li]], zs)
        for gi, (zx, zwx) in enumerate(shuffle_ev[p]):
            com = _term(shuffle_coms[p][gi])
            queries.append((x, 0, com, zx))
            queries.append((x_next, 1, com, zwx))
    fixed = [_term(c) for c in key.fixed]
    for qi, (col, rot) in enumerate(cs.fixed_queries):
        queries.append((key.rotate(x, rot), rot, fixed[col], fixed_ev[qi]))
    for i, com in enumerate(key.sigmas):
        queries.append((x, 0, _term(com), sigma_ev[i]))
    queries.append((x, 0, h_msm, h_eval))
    queries.append((x, 0, _term(random_com), random_ev))

    left, right = (_gwc if gwc else _shplonk)(t, queries)
    if not t.exhausted():
        return False, advice, "trailing bytes"
    # e(left, [s]G2) == e(right, G2)  <=>  s * left - right == 0
    total = bn254.msm(_scaled(left, key.s) + _scaled(right, R - 1))
    if total is not None:
        return False, advice, "opening check failed"
    return True, advice, ""
