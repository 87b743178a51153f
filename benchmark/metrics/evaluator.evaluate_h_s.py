"""Seconds a proof spends in the prover's `evaluate_h` phase, mean per
proof, from PhaseTimes (synchronising marks)."""


def read(ctx):
    s = ctx["phase_s"].get("evaluate_h")
    if s is None or not ctx["phase_proofs"]:
        return None
    return s / ctx["phase_proofs"]
