"""Kernel launches a proof makes (a count), from torch.profiler over the
traced proofs (no phase marks, as in the timed window)."""


def read(ctx):
    t = ctx["trace"]
    return None if not t else t["launches"] / t["proofs"]
