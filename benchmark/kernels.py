"""Which of the port's kernels belong to which layer, by the names the
device trace gives them (csrc/point_kernels.cu, csrc/field_kernels.cu)."""

from __future__ import annotations


def is_msm(name: str) -> bool:
    """The MSM's kernels: the bucket scan, the point ops and Horner
    combine, the small-MSM bucket kernel (not setup's ladder)."""
    return (("msm_scan" in name or "msm_bucket" in name or "point_" in name)
            and "point_ladder" not in name)


def is_ntt(name: str) -> bool:
    return "butterfly" in name or "mul_tiled" in name


def device_ms(ctx, pick) -> float | None:
    """Device milliseconds per traced proof of the kernels `pick` names."""
    t = ctx["trace"]
    if not t or not t["proofs"]:
        return None
    s = sum(v for name, v in t["kernels"].items() if pick(name))
    return 1e3 * s / t["proofs"] if s else None
