"""The comparison that decides `correct`: the program's verifying key and
every proof of the window against the plain reference.

- key_mismatch: the program's fixed and permutation commitments that differ
  from [sum_j v_j L_j(s)] G over the configuration's own columns;
- advice_mismatch: advice commitments of the proofs that differ from the
  reference's witness with the job's blinding rows (the prover draws them
  first from random.Random(prover seed): per instance, per advice column,
  one u16 per row from u to n);
- proofs_rejected: proofs the designated verifier (verifier.py) rejects,
  with the reference's own key.

Each has the limit 0.  Only host integers and the configuration's plain
module: nothing of the program is imported."""

from __future__ import annotations

import importlib
import random

from benchmark.reference import bn254, cs as cs_mod, lagrange
from benchmark.reference.verifier import Key, verify

LIMITS = {"key_mismatch": 0, "advice_mismatch": 0, "proofs_rejected": 0}


def toxic_s(setup_seed: int) -> int:
    """The secret of Params.unsafe_setup(k, seed=setup_seed): the first draw
    of random.Random(setup_seed) in [1, r)."""
    return random.Random(setup_seed).randrange(1, bn254.R)


class Reference:
    """The configuration's reference at one k, setup secret and set of
    witnesses (one per instance of a proof)."""

    def __init__(self, config: str, k: int, setup_seed: int, witnesses: list,
                 workers: int | None = None):
        self.spec = importlib.import_module(f"benchmark.reference.{config}")
        with open(self.spec.CS_FILE) as fh:
            self.cs = cs_mod.parse(fh.read())
        self.k, self.n = k, 1 << k
        self.u = self.spec.usable_rows(k)
        self.s = toxic_s(setup_seed)
        self.witnesses = list(witnesses)
        self.sums = lagrange.column_sums(
            self.spec.__name__, {"witnesses": self.witnesses}, k, self.s,
            workers)
        self.fixed = [bn254.mul(self.sums[f"fixed/{i}"])
                      for i in range(self.cs.num_fixed)]
        self.sigmas = [bn254.mul(self.sums[f"sigma/{i}"])
                       for i in range(len(self.cs.permutation))]
        self.key = Key(self.cs, self.spec.DEGREE, k, self.fixed, self.sigmas,
                       self.s)
        self.instances = [self.spec.instances(w) for w in self.witnesses]
        rows = {r for inst in self.instances for col in inst
                for r in range(len(col))}
        self.w = lagrange.weights(k, self.s, rows | set(range(self.u,
                                                              self.n)))
        self.instance_commitments = [
            [bn254.mul(sum(v * self.w[r] for r, v in enumerate(col)))
             for col in inst] for inst in self.instances]

    def key_mismatch(self, fixed: list, sigmas: list) -> int:
        """How many of the program's key commitments differ."""
        if len(fixed) != len(self.fixed) or len(sigmas) != len(self.sigmas):
            return len(self.fixed) + len(self.sigmas)
        return (sum(a != b for a, b in zip(fixed, self.fixed))
                + sum(a != b for a, b in zip(sigmas, self.sigmas)))

    def expected_advice(self, prover_seed: int) -> list:
        """Per instance, the commitment of each advice column with the
        blinding rows that `prover_seed` gives."""
        rng = random.Random(prover_seed)
        out = []
        for p in range(len(self.witnesses)):
            cols = []
            for c in range(self.cs.num_advice):
                acc = self.sums[f"advice/{p}/{c}"]
                for r in range(self.u, self.n):
                    acc += rng.randrange(1 << 16) * self.w[r]
                cols.append(bn254.mul(acc))
            out.append(cols)
        return out

    def check_proof(self, prover_seed: int, proof: bytes, gwc: bool) -> dict:
        ok, advice, reason = verify(self.key, self.instances, proof, gwc,
                                    self.instance_commitments)
        want = self.expected_advice(prover_seed)
        bad = sum(a != b for got, exp in zip(advice, want)
                  for a, b in zip(got, exp))
        if len(advice) != len(want):
            bad += sum(len(cols) for cols in want[len(advice):])
        return {"accepted": ok, "reason": reason, "advice_mismatch": bad}


def judge(ref: Reference, vk_fixed: list, vk_sigmas: list, proofs: list,
          gwc: bool) -> dict:
    """The numbers compared, over the key and (prover seed, proof) pairs."""
    out = {"key_mismatch": ref.key_mismatch(vk_fixed, vk_sigmas),
           "advice_mismatch": 0, "proofs_rejected": 0,
           "proofs_checked": len(proofs), "reasons": []}
    for seed, proof in proofs:
        r = ref.check_proof(seed, proof, gwc)
        out["advice_mismatch"] += r["advice_mismatch"]
        if not r["accepted"]:
            out["proofs_rejected"] += 1
            out["reasons"].append(r["reason"])
    return out
