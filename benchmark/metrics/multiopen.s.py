"""Seconds a proof spends in the prover's `multiopen` phase (GWC or
SHPLONK), mean per proof, from PhaseTimes (synchronising marks)."""


def read(ctx):
    s = ctx["phase_s"].get("multiopen")
    if s is None or not ctx["phase_proofs"]:
        return None
    return s / ctx["phase_proofs"]
