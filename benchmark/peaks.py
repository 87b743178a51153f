"""The table of peaks.  The data sheet gives no 32-bit integer rate, so
the integer peak is derived: an SM issues 64 integer multiply-adds a clock
(four SM sub-partitions of 16 INT32 lanes each, the Hopper SM), times the
card's SMs at its highest SM clock.  H100 SXM5 80 GB: 132 SMs at 1980 MHz
gives 64 * 132 * 1.98e9 = 16.73e12 multiply-adds a second; HBM3 3.35e12
bytes a second (NVIDIA's data sheet).  The rates assume the card's full
power limit (700 W)."""

from __future__ import annotations

CARDS = {
    "NVIDIA H100 80GB HBM3": {"sms": 132, "sm_clock_hz": 1.98e9,
                              "hbm_bytes_per_s": 3.35e12},
}
INT_MAD_PER_CLOCK_PER_SM = 64


def int_mad_per_s(kind: str) -> float | None:
    card = CARDS.get(kind)
    if card is None:
        return None
    return INT_MAD_PER_CLOCK_PER_SM * card["sms"] * card["sm_clock_hz"]
