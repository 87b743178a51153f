"""Device milliseconds a proof spends in the NTT's kernels, by name
(butterfly, mul_tiled), from torch.profiler over the traced proofs."""

from benchmark.kernels import device_ms, is_ntt


def read(ctx):
    return device_ms(ctx, is_ntt)
