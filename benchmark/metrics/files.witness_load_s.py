"""Seconds a proof spends in load_witness (every file it reads, the upload
waited for), mean over the proofs under PhaseTimes (the benchmark's own
span)."""


def read(ctx):
    if not ctx["phase_proofs"]:
        return None
    return ctx["witness_load_s"] / ctx["phase_proofs"]
