"""Seconds a proof spends in the arguments layer: the prover's phases
`lookup compress+m`, `shuffle compress` and `grand products/sums`
(permutation, logup and shuffle products), mean per proof, from
PhaseTimes (synchronising marks)."""

PHASES = ("lookup compress+m", "shuffle compress", "grand products/sums")


def read(ctx):
    seen = [ctx["phase_s"][p] for p in PHASES if p in ctx["phase_s"]]
    if not seen or not ctx["phase_proofs"]:
        return None
    return sum(seen) / ctx["phase_proofs"]
