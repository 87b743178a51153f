"""Device polynomial arithmetic: evaluation, Kate division, prefix sums.

Replacements for the host loops of halo2_proofs/src/arithmetic.rs:
  * eval_polynomial: powers-table + wide dot, log-depth — not Horner.
  * kate_division: closed form q_i = b^{-(i+1)} * (suffix sum of p_j b^j)
    via blocked prefix sums — the sequential reverse-Horner recurrence
    becomes two table muls + a scan.
  * field prefix/total sums via blocked integer sums of the limbs with a
    modular renormalisation (limbs are 16-bit, so 4096-wide blocks stay
    far below 2^32).
"""

from __future__ import annotations

import torch

from halo2_tpu_torch.fields.bn254 import FR_MODULUS, fr
from halo2_tpu_torch.fields.limbs import (LIMB_BITS, MASK, N_LIMBS,
                                          int_to_limbs_np, to_tensor)
from halo2_tpu_torch.ntt.ntt import powers_dev
from halo2_tpu_torch.utils import profiling

_BLOCK = 4096  # 4096 * (2^16-1) < 2^28: safe accumulation width


def _normalize_redundant(acc):
    """(16, *B) redundant limbs (int64, each < 2^32) of a sum V of
    Montgomery-form values -> canonical (16, *B) int32 limbs of V mod p.

    Split every limb into its low 16 bits and the rest: V = A + 2^16 * B
    with A, B < 2^256 in canonical limbs.  A Montgomery product by R mod p
    reduces A (A * R / R), one by 2^16 R mod p gives 2^16 B."""
    F = fr(acc.device)
    lo = (acc & MASK).to(torch.int32)
    hi = (acc >> LIMB_BITS).to(torch.int32)
    shift16 = to_tensor(int_to_limbs_np((F.R << LIMB_BITS) % F.p), acc.device)
    return F.add(F.mul(lo, F.one.to(acc.device)), F.mul(hi, shift16))


def field_sum(a):
    """Sum along the last axis: (16, *mid, n) -> (16, *mid)."""
    while a.shape[-1] > 1:
        n = a.shape[-1]
        c = min(n, _BLOCK)
        pad = (-n) % c
        if pad:
            a = torch.nn.functional.pad(a, (0, pad))
        blocks = a.reshape(a.shape[:-1] + ((n + pad) // c, c))
        # int32 sums (< 2^28): an int64 sum would first copy the whole
        # input at twice its size
        a = _normalize_redundant(
            blocks.sum(dim=-1, dtype=torch.int32).to(torch.int64))
    return a[..., 0]


def prefix_sum(a):
    """Inclusive field prefix sums along the last axis of (16, n)."""
    n = a.shape[-1]
    c = min(n, _BLOCK)
    pad = (-n) % c
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
    nb = (n + pad) // c
    intra = torch.cumsum(a.reshape(N_LIMBS, nb, c), dim=-1,
                         dtype=torch.int64)              # < 2^28 per limb
    if nb > 1:
        totals = _normalize_redundant(intra[:, :, -1])   # (16, nb)
        tot_prefix = prefix_sum(totals)                  # canonical (16, nb)
        intra[:, 1:, :] += tot_prefix[:, :-1, None]      # < 2^28 + 2^16
    return _normalize_redundant(intra.reshape(N_LIMBS, nb * c))[:, :n]


class PointPowers:
    """Powers table 1, z, z^2, ... z^{n-1} for a host scalar z (Montgomery),
    built on the device in log2(n) doubling rounds
    (tab_{2m} = [tab_m, tab_m * z^m], n Montgomery muls in all).

    A proof asks for the same few tables twice (evaluations, then the
    opening quotients), so the last few are kept; every proof's challenges
    are fresh, so older ones can never hit again and are dropped."""

    MAX_ENTRIES = 8
    _cache: dict = {}

    @classmethod
    def get(cls, z: int, n: int, device):
        device = torch.device(device)
        key = (z % FR_MODULUS, n, str(device))
        tab = cls._cache.get(key)
        if tab is None:
            tab = cls._build(z, n, device)
            cls._cache[key] = tab
            while len(cls._cache) > cls.MAX_ENTRIES:
                cls._cache.pop(next(iter(cls._cache)))
        return tab

    @staticmethod
    def _build(z: int, n: int, device):
        return powers_dev(fr(device), z, n)

    @classmethod
    def clear(cls):
        """Drop every table: a proof's challenges are never drawn again,
        so the prover lets its tables go when it is done (at 2^22 each is
        256 MiB; kept, they would sit in the next proof's peak)."""
        cls._cache.clear()


def _dot(coeffs, powers):
    return field_sum(fr(coeffs.device).mul(coeffs, powers))


def eval_poly(coeffs, z: int) -> int:
    """Evaluate (16, n) Montgomery coefficient vector at host scalar z;
    returns a canonical host int."""
    powers = PointPowers.get(z, coeffs.shape[-1], coeffs.device)
    return fr(coeffs.device).decode_scalar(_dot(coeffs, powers))


def eval_poly_batch(coeff_list, z: int) -> list:
    """Evaluate several same-length polys at z in one pass."""
    if not coeff_list:
        return []
    n = coeff_list[0].shape[-1]
    device = coeff_list[0].device
    profiling.incr("eval_batches")
    with profiling.span(f"eval_batch[{len(coeff_list)}x2^{n.bit_length()-1}]"):
        stack = torch.stack(list(coeff_list), dim=1)   # (16, C, n)
        with profiling.span("powers"):
            powers = PointPowers.get(z, n, device)
        out = _dot(stack, powers[:, None, :])          # (16, C)
        with profiling.span("decode"):
            return fr(device).decode(out)


def kate_division(p, b: int):
    """(p(X) - p(b)) / (X - b) for (16, n) Montgomery coeffs, host scalar b.

    Synthetic-division quotient q_i = sum_{j>i} p_j b^{j-i-1}, computed as
    b^{-(i+1)} * suffix-sum — fully parallel (arithmetic.rs:754-773 is the
    sequential original)."""
    F = fr(p.device)
    n = p.shape[-1]
    b = b % FR_MODULUS
    if b == 0:
        raise ValueError("kate_division at 0 is unsupported (a challenge is "
                         "nonzero with overwhelming probability)")
    binv = pow(b, FR_MODULUS - 2, FR_MODULUS)
    powb = PointPowers.get(b, n, p.device)
    # b^{-(i+1)} table = binv * binv^i
    powb_inv_shift = F.mul(PointPowers.get(binv, n, p.device),
                           F.encode_scalar(binv))
    num = F.mul(p, powb)                      # p_j b^j
    pref = prefix_sum(num)                    # inclusive prefix
    suffix = F.sub(pref[:, -1:], pref)        # s_i = sum_{j>i} p_j b^j
    return F.mul(suffix, powb_inv_shift)      # q_i = s_i * b^{-(i+1)}
