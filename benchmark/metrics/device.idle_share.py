"""The share of the traced window in which nothing ran on the device, in
%: 1 - (union of the device operations' intervals) / (window), from
torch.profiler over the traced proofs, which run without phase marks, as
the timed window's do."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
