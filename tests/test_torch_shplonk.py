"""The port's SHPLONK multiopen (halo2_tpu_torch/multiopen/shplonk.py)
against the JAX package, on the CPU.

  * the host helpers (Lagrange interpolation, the linear product, the
    vanishing value) and the intermediate sets against the reference's
    pure-Python helpers, and the sets against the record of
    tests/data/torch_golden_multi.json (a verifier-like query list with an
    advice column at two rotations and two fixed commitments of equal
    value, which stay two);
  * a SHPLONK opening of random polys made and checked by the port, with
    its query lists grouped as the reference groups them, and the
    linearisation check raising instead of passing a bad opening;
  * the SHPLONK proof of tests/test_shplonk.py's SimpleCircuit (K = 4,
    params seed 7, prover seed 0) byte-identical to the JAX package's,
    accepted (also through BatchVerifier across a vk file round trip), and
    rejected with a wrong instance or a flipped byte; the prover hands
    SHPLONK one object per column, so an advice column
    queried at two rotations is one commitment, as in the verifier.

Tolerance: none — bytes and integers are compared for equality.  The JAX
side comes from the golden file; the helpers it shares are host Python.
"""

import json
import os
import random

import pytest
import torch

from halo2_tpu.multiopen import shplonk as jshplonk

from halo2_tpu_torch.circuits import SimpleCircuit
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P, fr
from halo2_tpu_torch.io import load_vk, save_vk
from halo2_tpu_torch.multiopen import (BatchVerifier, ProverQuery,
                                       VerifierQuery, decider_verify, shplonk)
from halo2_tpu_torch.plonk import prover as prover_mod
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.arith import eval_poly
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_multi.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def simple(golden):
    """The port's key of SimpleCircuit and its SHPLONK proof with the
    golden record's seed; the rotation sets the prover handed SHPLONK."""
    rec = golden["proofs"]["simple_shplonk"]
    params = Params.unsafe_setup(rec["k"], seed=rec["params_seed"],
                                 device="cpu")
    vk, pk = keygen(params, SimpleCircuit(), device="cpu")
    seen = []

    def spy(params_, transcript, queries):
        seen.append(shplonk._construct_intermediate_sets(queries)[0])
        return shplonk.create_proof(params_, transcript, queries)

    (a, b), = rec["witnesses"]
    saved = prover_mod.shplonk
    prover_mod.shplonk = type("spy", (), {"create_proof": staticmethod(spy)})
    try:
        proof = create_proof(params, pk, SimpleCircuit(a, b),
                             rec["instances"][0], seed=rec["prover_seed"],
                             use_gwc=False, device="cpu")
    finally:
        prover_mod.shplonk = saved
    return {"params": params, "vk": vk, "proof": proof, "sets": seen[0],
            "rec": rec}


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_host_helpers_equal_the_reference(size):
    rng = random.Random(size)
    points = [rng.randrange(P) for _ in range(size)]
    evals = [rng.randrange(P) for _ in range(size)]
    coeffs = shplonk._lagrange_interpolate(points, evals)
    assert coeffs == jshplonk._lagrange_interpolate(points, evals)
    for x, y in zip(points, evals):
        assert sum(c * pow(x, k, P) for k, c in enumerate(coeffs)) % P == y
    c0 = rng.randrange(P)
    assert shplonk._poly_mul_linear(coeffs, c0) == \
        jshplonk._poly_mul_linear(coeffs, c0)
    u = rng.randrange(P)
    assert shplonk._eval_vanishing(points, u) == \
        jshplonk._eval_vanishing(points, u)


class _Query:
    def __init__(self, point, rotation, commitment):
        self.point, self.rotation, self.commitment = point, rotation, \
            commitment


def _golden_queries(record):
    """The recorded query list: one object per label, equal values kept
    apart."""
    points = {int(r): p for r, p in record["points"].items()}
    objs = {}
    for label, value, _ in record["queries"]:
        objs.setdefault(label, ("point", value))
    queries = [_Query(points[r], r, objs[label])
               for label, _, r in record["queries"]]
    return queries, {id(o): label for label, o in objs.items()}


def _described(sets, label_of):
    return [{"rotations": list(s["rotations"]), "points": s["points"],
             "commitments": [label_of[id(q.commitment)]
                             for q in s["queries"]]} for s in sets]


def test_intermediate_sets_equal_the_golden_and_the_reference(golden):
    record = golden["intermediate_sets"]
    queries, label_of = _golden_queries(record)
    sets, super_points = shplonk._construct_intermediate_sets(queries)
    assert _described(sets, label_of) == record["sets"]
    assert super_points == record["super_point_set"]
    jsets, jsuper = jshplonk._construct_intermediate_sets(queries)
    assert _described(jsets, label_of) == record["sets"]
    assert jsuper == super_points
    # the advice column queried at two rotations is one commitment of the
    # set {0, 1}; the two fixed commitments of equal value stay two
    by_rots = {tuple(s["rotations"]): s["commitments"]
               for s in record["sets"]}
    assert "advice_a" in by_rots[(0, 1)]
    assert {"fixed_0", "fixed_1"} <= set(by_rots[(0,)])


def test_intermediate_sets_refuse_two_points_for_one_rotation():
    with pytest.raises(ValueError):
        shplonk._construct_intermediate_sets(
            [_Query(5, 0, object()), _Query(6, 0, object())])


def _random_opening(params, reuse_slices: bool):
    """Prover and verifier queries over random polys: poly 0 at rotations
    0 and 1, poly 1 at 0 and -1, polys 2 and 3 equal in value (two
    commitments of one value) at 0.  With reuse_slices False the prover
    gets a new view of poly 0 for each query."""
    F = fr("cpu")
    n = params.n
    gen = torch.Generator().manual_seed(3)
    vals = [[int(v) for v in torch.randint(0, 1 << 62, (n,),
                                           generator=gen)]
            for _ in range(3)]
    stack = torch.stack([F.encode(v) for v in vals + [vals[2]]], dim=1)
    polys = list(stack.unbind(1))
    coms = params.commit_many_affine(polys)
    x = 1234567
    pts = {0: x, 1: x * 7 % P, -1: x * 11 % P}
    plan = [(0, 0), (0, 1), (1, 0), (1, -1), (2, 0), (3, 0)]
    prover_q, verifier_q = [], []
    for i, rot in plan:
        poly = stack[:, i, :] if (i == 0 and not reuse_slices) else polys[i]
        prover_q.append(ProverQuery(pts[rot], rot, poly))
        verifier_q.append(VerifierQuery(pts[rot], rot, coms[i],
                                        eval_poly(polys[i], pts[rot])))
    return prover_q, verifier_q


@pytest.fixture(scope="module")
def small_params():
    return Params.unsafe_setup(4, seed=3, device="cpu")


def test_random_opening_proves_and_verifies(small_params):
    prover_q, verifier_q = _random_opening(small_params, True)
    sets_p = shplonk._construct_intermediate_sets(prover_q)[0]
    sets_v = shplonk._construct_intermediate_sets(verifier_q)[0]
    assert [len(s["queries"]) for s in sets_p] == \
        [len(s["queries"]) for s in sets_v] == \
        [len(s["queries"]) for s in
         jshplonk._construct_intermediate_sets(verifier_q)[0]]
    assert [s["rotations"] for s in sets_p] == [(-1, 0), (0,), (0, 1)]
    t = Blake2bWrite()
    shplonk.create_proof(small_params, t, prover_q)
    proof = t.finalize()
    pv = small_params.verifier(0)
    pair = shplonk.verify_proof(pv, Blake2bRead(proof), verifier_q)
    assert decider_verify(pv, pair)
    verifier_q[2].eval = (verifier_q[2].eval + 1) % P
    pair = shplonk.verify_proof(pv, Blake2bRead(proof), verifier_q)
    assert not decider_verify(pv, pair)


def test_a_column_sliced_per_query_forms_two_commitments(small_params):
    """Why the prover slices each column once: two views of one column
    are two commitments to SHPLONK, and the sets no longer match the
    verifier's."""
    prover_q, verifier_q = _random_opening(small_params, False)
    sets_p = shplonk._construct_intermediate_sets(prover_q)[0]
    sets_v = shplonk._construct_intermediate_sets(verifier_q)[0]
    assert sum(len(s["queries"]) for s in sets_p) == \
        sum(len(s["queries"]) for s in sets_v) + 1


def test_linearisation_check_raises(small_params, monkeypatch):
    prover_q, _ = _random_opening(small_params, True)
    monkeypatch.setattr(shplonk, "eval_poly", lambda poly, u: 1)
    with pytest.raises(ValueError, match="linearisation"):
        shplonk.create_proof(small_params, Blake2bWrite(), prover_q)


def test_simple_circuit_proof_bytes_equal(simple):
    assert simple["proof"].hex() == simple["rec"]["proof_hex"]


def test_prover_queries_one_object_per_column(simple):
    """SimpleCircuit queries advice column 0 at rotations 0 and 1: the
    prover's sets hold it once, in the set {0, 1}, and hold as many
    commitments as the verifier reads — one a queried column, one a
    permutation product and sigma, h and the random poly."""
    cs = simple["vk"].cs
    sets = {s["rotations"]: len(s["queries"]) for s in simple["sets"]}
    assert (0, 1) in sets
    columns = sum(len({c.index for c, _ in qs}) for qs in (
        cs.instance_queries, cs.advice_queries, cs.fixed_queries))
    chunk = cs.degree() - 2
    products = -(-len(cs.permutation.columns) // chunk)
    assert sum(sets.values()) == (columns + len(cs.permutation.columns)
                                  + products + 2)


def test_port_verifier_accepts_and_rejects(simple, golden):
    rec = simple["rec"]
    pv = simple["params"].verifier(1)
    inst = rec["instances"][0]
    jax_proof = bytes.fromhex(rec["proof_hex"])
    assert verify_proof(pv, simple["vk"], inst, jax_proof, use_gwc=False)
    wrong = [[(inst[0][0] + 1) % P]]
    assert not verify_proof(pv, simple["vk"], wrong, jax_proof,
                            use_gwc=False)
    flipped = bytearray(jax_proof)
    flipped[-40] ^= 1
    try:
        ok = verify_proof(pv, simple["vk"], inst, bytes(flipped),
                          use_gwc=False)
    except ValueError:
        ok = False
    assert not ok
    # and the GWC reading of a SHPLONK proof fails
    try:
        ok = verify_proof(pv, simple["vk"], inst, jax_proof)
    except ValueError:
        ok = False
    assert not ok


def test_batch_verifier_across_a_vk_reload(simple, tmp_path):
    """Both packages' SHPLONK proofs into one BatchVerifier, the second
    with the vk written and read back: one pairing check accepts them,
    and a wrong instance among them fails it."""
    rec = simple["rec"]
    pv = simple["params"].verifier(1)
    inst = rec["instances"][0]
    path = str(tmp_path / "vk.bin")
    save_vk(simple["vk"], path)
    vk2 = load_vk(simple["params"], SimpleCircuit(), path)
    batch, bad_batch = BatchVerifier(seed=3), BatchVerifier(seed=3)
    for proof, vk in ((bytes.fromhex(rec["proof_hex"]), simple["vk"]),
                      (simple["proof"], vk2)):
        verify_proof(pv, vk, inst, proof, use_gwc=False, strategy=batch)
        verify_proof(pv, vk, [[(inst[0][0] + 1) % P]] if vk is vk2 else inst,
                     proof, use_gwc=False, strategy=bad_batch)
    assert batch.finalize(pv)
    assert not bad_batch.finalize(pv)
