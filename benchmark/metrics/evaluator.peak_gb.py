"""The peak of allocated device memory within the `evaluate_h` phase, in
GB (1e9 bytes), the highest over the window (PhaseTimes(peaks=True))."""


def read(ctx):
    peak = ctx["phase_peak"].get("evaluate_h")
    return None if not peak else peak / 1e9
