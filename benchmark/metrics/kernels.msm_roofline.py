"""The MSM kernels' share of their roofline, in %: the least time the
card could take for the proof's MSMs (benchmark/work.py's operation count
at the card's integer multiply-add rate, benchmark/peaks.py) over their
device time (poly.msm_device_ms)."""

from benchmark import peaks, work
from benchmark.kernels import device_ms, is_msm


def read(ctx):
    rate = peaks.int_mad_per_s(ctx["device_kind"])
    calls = ctx["counters"].get("msm_calls", 0)
    points = ctx["counters"].get("msm_points", 0)
    ms = device_ms(ctx, is_msm)
    if rate is None or not calls or not ms or not ctx["proofs"]:
        return None
    per_proof = calls / ctx["proofs"]
    least_s = per_proof * work.msm_mads(points / calls) / rate
    return 100.0 * least_s / (ms / 1e3)
