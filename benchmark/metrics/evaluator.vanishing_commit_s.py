"""Seconds a proof spends in the prover's `vanishing commit` phase, mean
per proof, from PhaseTimes (synchronising marks): the vanishing blind
(its random bytes drawn on the host, decoded on the device) and its
commitment.  With the key's Lagrange forms offloaded (k = 22) the phase
also holds their offload, which the prover makes just before the blind."""


def read(ctx):
    s = ctx["phase_s"].get("vanishing commit")
    if s is None or not ctx["phase_proofs"]:
        return None
    return s / ctx["phase_proofs"]
