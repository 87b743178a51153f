"""The verifier — verify_proof.

Host-side mirror of halo2_proofs/src/plonk/verifier.rs:128-473
(verify_proof_ext): read the transcript in the prover's exact order,
recompute the folded constraint value at x, assemble the verifier query
stream, run the GWC PairMSM and the final pairing Decider.  All math is
host big-int — the verifier is cheap by design and never touches the
device.
"""

from __future__ import annotations

from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.multiopen import HostMSM, VerifierQuery, decider_verify
from halo2_tpu_torch.multiopen import gwc
from halo2_tpu_torch.plonk import permutation as perm_mod
from halo2_tpu_torch.plonk.circuit import eval_expression_host
from halo2_tpu_torch.plonk.evaluator import refuse_unported_arguments
from halo2_tpu_torch.transcript import Blake2bRead

P = FR_MODULUS


def verify_proof(params_verifier, vk, instances, proof: bytes,
                 use_gwc: bool = True, strategy=None):
    """Verify a single-instance proof.  strategy=None: immediate pairing
    (SingleVerifier); strategy=BatchVerifier: accumulate, finalize later."""
    if not use_gwc:
        raise NotImplementedError(
            "the SHPLONK multiopen is not ported to halo2_tpu_torch yet")
    cs = vk.cs
    refuse_unported_arguments(cs)
    domain = vk.domain
    n = params_verifier.n
    bf = cs.blinding_factors()
    transcript = Blake2bRead(proof)

    if len(instances) != cs.num_instance_columns:
        raise ValueError("wrong number of instance columns")
    for col in instances:
        if len(col) > n - (bf + 1):
            raise ValueError("instance too large")

    instance_commitments = [params_verifier.commit_lagrange(list(col))
                            for col in instances]

    vk.hash_into(transcript)
    for com in instance_commitments:
        transcript.common_point(com)

    advice_commitments = [transcript.read_point()
                          for _ in range(cs.num_advice_columns)]
    transcript.squeeze_challenge()          # theta
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    perm_z_commitments = perm_mod.read_product_commitments(cs, transcript)
    random_commitment = transcript.read_point()
    y = transcript.squeeze_challenge()
    h_commitments = [transcript.read_point()
                     for _ in range(domain.get_quotient_poly_degree())]
    x = transcript.squeeze_challenge()

    instance_evals = [transcript.read_scalar() for _ in cs.instance_queries]
    advice_evals = [transcript.read_scalar() for _ in cs.advice_queries]
    fixed_evals = [transcript.read_scalar() for _ in cs.fixed_queries]
    random_eval = transcript.read_scalar()
    perm_common_evals = [transcript.read_scalar()
                         for _ in cs.permutation.columns]
    perm_sets = perm_mod.read_set_evals(cs, len(perm_z_commitments),
                                        transcript)

    # ---- expected h(x) ----------------------------------------------------
    xn = pow(x, n, P)
    l_evals = domain.l_i_range(x, xn, range(-(bf + 1), 1))
    l_last = l_evals[0]
    l_blind = sum(l_evals[1: 1 + bf]) % P
    l_0 = l_evals[1 + bf]

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
    for qi, (column, rot) in enumerate(cs.instance_queries):
        queries.append(VerifierQuery(domain.rotate_omega(x, rot), rot,
                                     instance_commitments[column.index],
                                     instance_evals[qi]))
    for qi, (column, rot) in enumerate(cs.advice_queries):
        queries.append(VerifierQuery(domain.rotate_omega(x, rot), rot,
                                     advice_commitments[column.index],
                                     advice_evals[qi]))
    for i, s in enumerate(perm_sets):
        queries.append(VerifierQuery(x, 0, perm_z_commitments[i], s.z_x))
        queries.append(VerifierQuery(x_next, 1, perm_z_commitments[i],
                                     s.z_wx))
    for i in range(len(perm_sets) - 2, -1, -1):
        queries.append(VerifierQuery(x_last, -(bf + 1),
                                     perm_z_commitments[i],
                                     perm_sets[i].z_last))
    for qi, (column, rot) in enumerate(cs.fixed_queries):
        queries.append(VerifierQuery(domain.rotate_omega(x, rot), rot,
                                     vk.fixed_commitments[column.index],
                                     fixed_evals[qi]))
    for i, com in enumerate(vk.permutation.commitments):
        queries.append(VerifierQuery(x, 0, com, perm_common_evals[i]))
    queries.append(VerifierQuery(x, 0, h_msm, expected_h_eval))
    queries.append(VerifierQuery(x, 0, random_commitment, random_eval))

    pair = gwc.verify_proof(params_verifier, transcript, queries)
    transcript.assert_exhausted()
    if strategy is not None:
        strategy.add(pair)
        return True
    return decider_verify(params_verifier, pair)
