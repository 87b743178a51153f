"""Device milliseconds a proof spends in the MSM's kernels, by name
(msm_scan, point_*, msm_bucket), from torch.profiler over the traced
proofs."""

from benchmark.kernels import device_ms, is_msm


def read(ctx):
    return device_ms(ctx, is_msm)
