"""The verifier — verify_proof / verify_proof_multi.

Host-side mirror of halo2_proofs/src/plonk/verifier.rs:128-473
(verify_proof_ext): read the transcript in the prover's exact order (one
or several instances of one circuit), recompute the folded constraint
value at x, assemble the verifier query stream, run the GWC or SHPLONK
PairMSM and the final pairing Decider.  All math is
host big-int — the verifier is cheap by design and never touches the
device.
"""

from __future__ import annotations

from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.multiopen import HostMSM, VerifierQuery, decider_verify
from halo2_tpu_torch.multiopen import gwc, shplonk
from halo2_tpu_torch.plonk import permutation as perm_mod
from halo2_tpu_torch.plonk.circuit import eval_expression_host
from halo2_tpu_torch.transcript import Blake2bRead

P = FR_MODULUS


def verify_proof(params_verifier, vk, instances, proof: bytes,
                 use_gwc: bool = True, strategy=None):
    """Verify a single-instance proof.  strategy=None: immediate pairing
    (SingleVerifier); strategy=BatchVerifier: accumulate, finalize later."""
    return verify_proof_multi(params_verifier, vk, [instances], proof,
                              use_gwc=use_gwc, strategy=strategy)


def verify_proof_multi(params_verifier, vk, instances_list, proof: bytes,
                       use_gwc: bool = True, strategy=None):
    """Verify a proof of several instances of one circuit
    (create_proof_multi); use_gwc False reads a SHPLONK opening."""
    cs = vk.cs
    domain = vk.domain
    n = params_verifier.n
    bf = cs.blinding_factors()
    transcript = Blake2bRead(proof)
    proofs = range(len(instances_list))

    for instances in instances_list:
        if len(instances) != cs.num_instance_columns:
            raise ValueError("wrong number of instance columns")
        for col in instances:
            if len(col) > n - (bf + 1):
                raise ValueError("instance too large")

    instance_commitments = [
        [params_verifier.commit_lagrange(list(col)) for col in instances]
        for instances in instances_list]

    vk.hash_into(transcript)
    for coms in instance_commitments:
        for com in coms:
            transcript.common_point(com)

    advice_commitments = [[transcript.read_point()
                           for _ in range(cs.num_advice_columns)]
                          for _ in proofs]
    theta = transcript.squeeze_challenge()
    lookup_m_commitments = [[transcript.read_point() for _ in cs.lookups]
                            for _ in proofs]
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    perm_z_commitments = [perm_mod.read_product_commitments(cs, transcript)
                          for _ in proofs]
    lookup_z_commitments = [
        [[transcript.read_point() for _ in lookup.input_expressions_sets]
         for lookup in cs.lookups] for _ in proofs]
    shuffle_z_commitments = [[transcript.read_point() for _ in cs.shuffles]
                             for _ in proofs]
    random_commitment = transcript.read_point()
    y = transcript.squeeze_challenge()
    h_commitments = [transcript.read_point()
                     for _ in range(domain.get_quotient_poly_degree())]
    x = transcript.squeeze_challenge()

    instance_evals = [[transcript.read_scalar() for _ in cs.instance_queries]
                      for _ in proofs]
    advice_evals = [[transcript.read_scalar() for _ in cs.advice_queries]
                    for _ in proofs]
    fixed_evals = [transcript.read_scalar() for _ in cs.fixed_queries]
    random_eval = transcript.read_scalar()
    perm_common_evals = [transcript.read_scalar()
                         for _ in cs.permutation.columns]
    perm_sets = [perm_mod.read_set_evals(cs, len(perm_z_commitments[p]),
                                         transcript) for p in proofs]
    lookup_evals = []      # per proof, per lookup: (m_eval, [(z_x, z_wx,
    for _ in proofs:       # z_last)])
        per_proof = []
        for lookup in cs.lookups:
            m_eval = transcript.read_scalar()
            zsets = []
            ns = len(lookup.input_expressions_sets)
            for i in range(ns):
                z_x = transcript.read_scalar()
                z_wx = transcript.read_scalar()
                z_last = transcript.read_scalar() if i + 1 < ns else None
                zsets.append((z_x, z_wx, z_last))
            per_proof.append((m_eval, zsets))
        lookup_evals.append(per_proof)
    shuffle_evals = [[(transcript.read_scalar(), transcript.read_scalar())
                      for _ in cs.shuffles] for _ in proofs]

    # ---- expected h(x) ----------------------------------------------------
    xn = pow(x, n, P)
    l_evals = domain.l_i_range(x, xn, range(-(bf + 1), 1))
    l_last = l_evals[0]
    l_blind = sum(l_evals[1: 1 + bf]) % P
    l_0 = l_evals[1 + bf]
    active_rows = (1 - (l_last + l_blind)) % P

    expressions = []
    for p in proofs:
        expressions += _proof_expressions(
            cs, advice_evals[p], instance_evals[p], fixed_evals, perm_sets[p],
            perm_common_evals, lookup_evals[p], shuffle_evals[p], theta,
            beta, gamma, x, l_0, l_last, l_blind, active_rows)

    h_eval = 0
    for v in expressions:
        h_eval = (h_eval * y + v) % P
    expected_h_eval = h_eval * pow((xn - 1) % P, P - 2, P) % P

    h_msm = HostMSM()
    for com in reversed(h_commitments):
        h_msm.scale(xn)
        h_msm.append_term(1, com)

    # ---- query stream (verifier.rs:386-460 order) ------------------------
    x_next = domain.rotate_omega(x, 1)
    x_last = domain.rotate_omega(x, -(bf + 1))
    queries = []
    for p in proofs:
        for qi, (column, rot) in enumerate(cs.instance_queries):
            queries.append(VerifierQuery(
                domain.rotate_omega(x, rot), rot,
                instance_commitments[p][column.index], instance_evals[p][qi]))
        for qi, (column, rot) in enumerate(cs.advice_queries):
            queries.append(VerifierQuery(
                domain.rotate_omega(x, rot), rot,
                advice_commitments[p][column.index], advice_evals[p][qi]))
        zcoms = perm_z_commitments[p]
        for i, s in enumerate(perm_sets[p]):
            queries.append(VerifierQuery(x, 0, zcoms[i], s.z_x))
            queries.append(VerifierQuery(x_next, 1, zcoms[i], s.z_wx))
        for i in range(len(perm_sets[p]) - 2, -1, -1):
            queries.append(VerifierQuery(x_last, -(bf + 1), zcoms[i],
                                         perm_sets[p][i].z_last))
        for li, (m_eval, zsets) in enumerate(lookup_evals[p]):
            zcoms = lookup_z_commitments[p][li]
            queries.append(VerifierQuery(x, 0, lookup_m_commitments[p][li],
                                         m_eval))
            for zi, (z_x, z_wx, _) in enumerate(zsets):
                queries.append(VerifierQuery(x, 0, zcoms[zi], z_x))
                queries.append(VerifierQuery(x_next, 1, zcoms[zi], z_wx))
            for zi in range(len(zsets) - 2, -1, -1):
                queries.append(VerifierQuery(x_last, -(bf + 1), zcoms[zi],
                                             zsets[zi][2]))
        for gi, (z_x, z_wx) in enumerate(shuffle_evals[p]):
            com = shuffle_z_commitments[p][gi]
            queries.append(VerifierQuery(x, 0, com, z_x))
            queries.append(VerifierQuery(x_next, 1, com, z_wx))
    for qi, (column, rot) in enumerate(cs.fixed_queries):
        queries.append(VerifierQuery(domain.rotate_omega(x, rot), rot,
                                     vk.fixed_commitments[column.index],
                                     fixed_evals[qi]))
    for i, com in enumerate(vk.permutation.commitments):
        queries.append(VerifierQuery(x, 0, com, perm_common_evals[i]))
    queries.append(VerifierQuery(x, 0, h_msm, expected_h_eval))
    queries.append(VerifierQuery(x, 0, random_commitment, random_eval))

    pair = (gwc if use_gwc else shplonk).verify_proof(params_verifier,
                                                      transcript, queries)
    transcript.assert_exhausted()
    if strategy is not None:
        strategy.add(pair)
        return True
    return decider_verify(params_verifier, pair)


def _proof_expressions(cs, advice_evals, instance_evals, fixed_evals,
                       perm_sets, perm_common_evals, lookup_evals,
                       shuffle_evals, theta, beta, gamma, x, l_0, l_last,
                       l_blind, active_rows) -> list:
    """The constraint values at x of one proof's gates, permutation,
    lookups and shuffles, in the prover's fold order."""
    def host_eval(e):
        return eval_expression_host(
            e,
            lambda q: fixed_evals[q.query_index],
            lambda q: advice_evals[q.query_index],
            lambda q: instance_evals[q.query_index])

    expressions = []
    for gate in cs.gates:
        for poly in gate.polys:
            expressions.append(host_eval(poly))

    def query_eval(column):
        idx = cs.get_any_query_index(column, 0)
        return {"advice": advice_evals, "fixed": fixed_evals,
                "instance": instance_evals}[column.ctype][idx]

    expressions.extend(perm_mod.verifier_expressions(
        cs, perm_sets, perm_common_evals, query_eval,
        l_0, l_last, l_blind, beta, gamma, x))

    def compress_evals(exprs):
        acc = 0
        for e in exprs:
            acc = (acc * theta + host_eval(e)) % P
        return acc

    def phi_terms(input_set):
        """(prod_i phi_i, sum_i 1/phi_i) of one input set at x."""
        phi = [(compress_evals(inputs) + beta) % P for inputs in input_set]
        product = 1
        for p_ in phi:
            product = product * p_ % P
        return product, sum(pow(p_, P - 2, P) for p_ in phi) % P

    # logup expressions (logup/verifier.rs:101-220)
    for lookup, (m_eval, zsets) in zip(cs.lookups, lookup_evals):
        sets = lookup.input_expressions_sets
        expressions.append(l_0 * zsets[0][0] % P)
        expressions.append(l_last * zsets[-1][0] % P)
        product_fi, sum_inv = phi_terms(sets[0])
        tau = (compress_evals(lookup.table_expressions) + beta) % P
        z_gx_minus_zx = (zsets[0][1] - zsets[0][0]) % P
        left = (tau * z_gx_minus_zx + m_eval) % P * product_fi % P
        right = tau * product_fi % P * sum_inv % P
        expressions.append((left - right) % P * active_rows % P)
        for i in range(1, len(sets)):
            expressions.append(
                l_0 * ((zsets[i][0] - zsets[i - 1][2]) % P) % P)
        for i in range(1, len(sets)):
            product_fi, sum_inv = phi_terms(sets[i])
            left = (zsets[i][1] - zsets[i][0]) % P
            expressions.append(
                (left - sum_inv) % P * product_fi % P * active_rows % P)

    # shuffle expressions (shuffle/verifier.rs:60-127)
    for group, (z_x, z_wx) in zip(cs.shuffles, shuffle_evals):
        prod_shuffle, prod_input = 1, 1
        chal = beta
        for unit in group.units:
            prod_shuffle = prod_shuffle * (
                (compress_evals(unit.shuffle_expressions) + chal) % P) % P
            prod_input = prod_input * (
                (compress_evals(unit.input_expressions) + chal) % P) % P
            chal = chal * beta % P
        expressions.append(l_0 * ((1 - z_x) % P) % P)
        expressions.append(l_last * ((z_x * z_x - z_x) % P) % P)
        expressions.append(
            (z_wx * prod_shuffle - z_x * prod_input) % P * active_rows % P)
    return expressions
