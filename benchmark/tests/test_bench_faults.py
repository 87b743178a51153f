"""The harness, without its look for a chip, driven with the timed path
broken underneath: `correct` has to come out false for each fault a cell
of proofs can have, and for the control (a stored witness with one cell
changed).  One card's cells have no exchange between chips."""

import helpers
from benchmark import control
from halo2_tpu_torch.plonk import prover


def _broken(monkeypatch, wrap):
    real = prover.create_proof_multi
    monkeypatch.setattr(prover, "create_proof_multi",
                        lambda *a, **kw: wrap(real, *a, **kw))


def test_stale_proof_is_caught(monkeypatch):
    """A step that returns its state unchanged: every job gets the first
    proof the prover made."""
    made = []

    def stale(real, *a, **kw):
        if not made:
            made.append(real(*a, **kw))
        return made[0]
    _broken(monkeypatch, stale)
    result, compared = helpers.run("t.plonk.k4", 41)
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in compared)["advice_mismatch"] > 0


def test_half_the_batch_left_out_is_caught(monkeypatch):
    """Two instances a proof, the second left out."""
    def half(real, params, pk, circuits, instances, **kw):
        kw["witness_advice"] = kw["witness_advice"][:1]
        return real(params, pk, circuits[:1], instances[:1], **kw)
    _broken(monkeypatch, half)
    result, compared = helpers.run("t.plonk.k4.x2", 42)
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in compared)["proofs_rejected"] > 0


def test_altered_answer_is_caught(monkeypatch):
    """One byte of each proof altered where it is produced."""
    def flipped(real, *a, **kw):
        proof = bytearray(real(*a, **kw))
        proof[len(proof) // 2] ^= 1
        return bytes(proof)
    _broken(monkeypatch, flipped)
    result, compared = helpers.run("t.plonk.k4", 43)
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in compared)["proofs_rejected"] > 0


def test_control_comes_out_not_correct():
    with control.broken_witnesses(44):
        result, compared = helpers.run("t.plonk.k4", 44)
    numbers = dict((n, v) for n, v, _ in compared)
    assert not result["correct"]
    assert numbers["proofs_rejected"] == result["attempted"]
    assert numbers["advice_mismatch"] >= result["attempted"]
