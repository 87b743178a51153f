"""GWC19 multiopen (the default scheme; "use_gwc=true" path).

Mirrors halo2_proofs/src/poly/multiopen/gwc.rs and
gwc/{prover,verifier}.rs:
  * queries grouped by ROTATION in ascending order (BTreeMap over the i32
    rotation, gwc.rs:38-63);
  * prover: per point z, fold the group's polys with v (device), evaluate,
    Kate-divide by (X - z) (parallel closed form), commit witness W;
  * verifier: two-channel PairMSM with u-powers (gwc/verifier.rs:17-91).
"""

from __future__ import annotations

from halo2_tpu_torch.curves import host
from halo2_tpu_torch.fields.bn254 import FR_MODULUS, fr
from halo2_tpu_torch.multiopen.common import HostMSM, PairMSM
from halo2_tpu_torch.poly.arith import kate_division

P = FR_MODULUS


def _group_by_rotation(queries):
    groups: dict[int, list] = {}
    for q in queries:
        groups.setdefault(q.rotation, []).append(q)
    return [groups[r] for r in sorted(groups)]


def _fold_polys(F, polys, v):
    """polys: (16, n) coeff polys (first = highest v power); v: (16,).
    batch = ((p0 v + p1) v + p2) v + ..."""
    acc = polys[0]
    for p in polys[1:]:
        acc = F.add(F.mul(acc, v), p)
    return acc


def create_proof(params, transcript, queries):
    F = fr(params.device)
    v = transcript.squeeze_challenge()
    v_l = F.encode_scalar(v)
    witnesses = []
    for group in _group_by_rotation(queries):
        z = group[0].point
        if any(q.point != z for q in group):
            raise ValueError("queries of one rotation must share their point")
        batch = _fold_polys(F, [q.poly for q in group], v_l)
        witnesses.append(kate_division(batch, z))
    # no challenge is drawn between the witness commitments, so they are
    # one batched MSM
    for w in params.commit_many_affine(witnesses):
        transcript.write_point(w)


def verify_proof(params_verifier, transcript, queries) -> PairMSM:
    v = transcript.squeeze_challenge()
    u = transcript.squeeze_challenge()

    commitment_multi = HostMSM()
    eval_multi = 0
    witness = HostMSM()
    witness_with_aux = HostMSM()

    for group in _group_by_rotation(queries):
        z = group[0].point
        wi = transcript.read_point()

        witness_with_aux.scale(u)
        witness_with_aux.append_term(z, wi)
        witness.scale(u)
        witness.append_term(1, wi)
        commitment_multi.scale(u)
        eval_multi = eval_multi * u % P

        commitment_batch = HostMSM()
        eval_batch = 0
        for q in group:
            assert q.point == z
            commitment_batch.scale(v)
            if isinstance(q.commitment, HostMSM):
                commitment_batch.add_msm(q.commitment)
            else:
                commitment_batch.append_term(1, q.commitment)
            eval_batch = (eval_batch * v + q.eval) % P

        commitment_multi.add_msm(commitment_batch)
        eval_multi = (eval_multi + eval_batch) % P

    left = HostMSM()
    left.add_msm(witness)

    right = HostMSM()
    right.add_msm(witness_with_aux)
    right.add_msm(commitment_multi)
    right.append_term(eval_multi, host.neg(params_verifier.g1))
    return PairMSM(left, right)
