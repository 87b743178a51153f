#!/usr/bin/env python3
"""Tensor-core DFT probe: can the H100's tensor cores do exact Fr
arithmetic for the m-point stage of an NTT?

    M=16 B=131072 python3 examples/torch_mxu_dft_probe.py     (M = 16 or 64)

An m-point DFT over Fr is a linear map over the input's bytes, so it runs
as two exact bf16 "nibble" matrix products with float32 sums and an
epilogue kernel (K6) that turns the sums into 17 16-bit limbs
(halo2_tpu_torch/ntt/dft_matmul.py).  On one CUDA card this prints, as one
JSON object: exactness mod p against the host big-int DFT (`host_dft`) on
a few columns, among them all-0xFF inputs, which make every product sum as
large as these matrices allow; K6 against its plain version, limb for
limb; and milliseconds per batch of B transforms (CUDA events, after a warm
call) for the whole `dft_matmul`, the two products alone, K6 alone and the
port's CIOS NTT of the same size through kernels K2 / K3, each beside the
least time the card could take for it.  Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.fields.limbs import N_LIMBS, limbs_to_ints  # noqa: E402
from halo2_tpu_torch.ntt import dft_matmul as dm  # noqa: E402
from halo2_tpu_torch.ntt.ntt import NTT  # noqa: E402
from halo2_tpu_torch.utils.profiling import (BF16_FLOP_PER_S,  # noqa: E402
                                            bound_ms, max_abs_err,
                                            time_cuda, time_graph)

# 32-bit integer operations K6 does for one output element: 64 float ->
# int conversions, 64 to combine the nibble sums into bytes, 96 to place
# the bytes in limbs, 54 + 51 for the two ripples, 160 for the fold
EPILOGUE_OPS = 64 + 64 + 96 + 54 + 160 + 51

# columns of the probe's input that are checked against host_dft
SPECIAL_COL, ALL_FF_COL = 0, 1


def epilogue_bound(m: int, B: int):
    """K6: reads lo and hi once, (m*32, B) float32 each, writes (17, m, B)
    int32 words."""
    return bound_ms((2 * dm.NB + dm.OUT_LIMBS) * m * B * 4,
                    EPILOGUE_OPS * m * B)


def products_bound(m: int, B: int):
    """The two nibble products: 2 x 2 (m*32)^2 B flop on bf16 tensor cores;
    bytes: the bf16 matrices and byte matrix read once, the two float32
    results written once."""
    k = m * dm.NB
    return bound_ms((2 * k * k + k * B) * 2 + 2 * k * B * 4,
                    4 * k * k * B, BF16_FLOP_PER_S)


def probe_input(m: int, B: int, device, seed: int = 0) -> torch.Tensor:
    """(16, m, B) int32 limbs: random values below 2^252 < p, except column
    SPECIAL_COL, which starts 0, 1, p - 1, and column ALL_FF_COL, whose
    bytes are all 0xFF (2^256 - 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randint(0, 1 << 16, (N_LIMBS, m, B), dtype=torch.int32,
                      device=device, generator=gen)
    x[N_LIMBS - 1] &= 0x0FFF
    for j, v in enumerate((0, 1, dm.P - 1)[:m]):
        x[:, j, SPECIAL_COL] = torch.tensor(
            [(v >> (16 * k)) & 0xFFFF for k in range(N_LIMBS)],
            dtype=torch.int32)
    x[:, :, ALL_FF_COL] = 0xFFFF
    return x


def check_columns(B: int) -> list:
    """The columns checked against host_dft: the special ones, two random
    ones and the last (the ragged edge of any tiling)."""
    return sorted({SPECIAL_COL, ALL_FF_COL, 2, B // 2, B - 1} &
                  set(range(B)))


def exact_mod_p(x: torch.Tensor, out: torch.Tensor, w: int, m: int,
                cols) -> bool:
    """Every checked column of `out` is congruent mod p to host_dft of the
    same column of `x`, and below 2^271."""
    xs = x[:, :, cols].cpu().numpy()
    got = out[:, :, cols].cpu().numpy()
    for c in range(len(cols)):
        want = dm.host_dft(limbs_to_ints(xs[:, :, c]), w, m)
        have = limbs_to_ints(got[:, :, c])
        if any(h % dm.P != v or h >= 1 << 271 for h, v in zip(have, want)):
            return False
    return True


def ntt_agrees(x: torch.Tensor, out: torch.Tensor, ntt: NTT, cols) -> bool:
    """The CIOS NTT of the checked columns whose values are below p equals
    the DFT output reduced mod p (the NTT is linear, so running it on the
    raw values as Montgomery words gives the raw DFT)."""
    cols = [c for c in cols if c != ALL_FF_COL]
    xt = x[:, :, cols].transpose(1, 2).contiguous()          # (16, c, m)
    got = ntt.forward(xt).cpu().numpy()
    want = out[:, :, cols].cpu().numpy()
    for c in range(len(cols)):
        if limbs_to_ints(got[:, c, :]) != [v % dm.P for v in
                                           limbs_to_ints(want[:, :, c])]:
            return False
    return True


def measure(m: int, B: int, x: torch.Tensor, mats, reps: int = 10) -> dict:
    """Times on the card, ms per batch of B m-point transforms, and ns per
    element, each beside its bound; the NTT baseline is the port's CIOS
    four-step NTT over (16, B, m) through kernels K2 and K3."""
    M_lo, M_hi, w = mats
    n_el = m * B
    xk = dm.bytes_from_limbs(x).reshape(m * dm.NB, B).to(torch.bfloat16)
    lo, hi = dm.dft_products(M_lo, M_hi, xk)
    ntt = NTT(m.bit_length() - 1, x.device, omega=w)
    xt = x.transpose(1, 2).contiguous()
    t = {
        "dft_matmul": time_cuda(lambda: dm.dft_matmul(x, M_lo, M_hi, m),
                                reps),
        "products": time_cuda(lambda: dm.dft_products(M_lo, M_hi, xk),
                              reps),
        "epilogue_k6": time_cuda(lambda: dm.dft_epilogue(lo, hi, m), reps),
        "epilogue_k6_device": time_graph(
            lambda: dm.dft_epilogue(lo, hi, m), reps),
        "epilogue_plain": time_cuda(
            lambda: dm.plain_dft_epilogue(lo, hi, m), 2),
        "ntt_cios": time_cuda(lambda: ntt.forward(xt), reps),
    }
    k6_bound, k6_by = epilogue_bound(m, B)
    mm_bound, mm_by = products_bound(m, B)
    return {
        "m": m, "B": B, "elements": n_el,
        "ms": t,
        "ns_per_element": {k: v * 1e6 / n_el for k, v in t.items()},
        "bound_ms": {"epilogue_k6": k6_bound, "products": mm_bound},
        "bound_by": {"epilogue_k6": k6_by, "products": mm_by},
        "ntt_over_dft": t["ntt_cios"] / t["dft_matmul"],
    }


def check(x: torch.Tensor, out: torch.Tensor, mats, m: int) -> dict:
    """Checks of one dft_matmul output `out` of the input `x`: exact mod p
    against host_dft, equal to the CIOS NTT mod p, and K6 equal to its
    plain version on the same products.  Raises if one fails."""
    M_lo, M_hi, w = mats
    B = x.shape[2]
    cols = check_columns(B)
    exact = exact_mod_p(x, out, w, m, cols)
    ntt_ok = ntt_agrees(x, out, NTT(m.bit_length() - 1, x.device, omega=w),
                        cols)
    lo, hi = dm.dft_products(
        M_lo, M_hi, dm.bytes_from_limbs(x).reshape(m * dm.NB, B))
    k6_err = max_abs_err(dm.dft_epilogue(lo, hi, m),
                     dm.plain_dft_epilogue(lo, hi, m))
    if not exact or not ntt_ok or k6_err:
        raise AssertionError(f"m={m}, B={B}: exact mod p {exact}, NTT "
                             f"agrees {ntt_ok}, K6 max abs err {k6_err}")
    return {"exact_mod_p": exact, "checked_columns": cols,
            "all_ff_column_checked": ALL_FF_COL in cols,
            "ntt_agrees": ntt_ok, "epilogue_max_abs_err": k6_err}


def run(m: int, B: int, device, seed: int = 0, reps: int = 10) -> dict:
    """Exactness and times of one probe size; raises if a check fails."""
    mats = dm.dft_matrices(m, device)
    x = probe_input(m, B, device, seed)
    res = check(x, dm.dft_matmul(x, mats[0], mats[1], m), mats, m)
    res.update(measure(m, B, x, mats, reps))
    return res


def main() -> int:
    m = int(os.environ.get("M", "16"))
    B = int(os.environ.get("B", str(1 << 17)))
    if not torch.cuda.is_available():
        print("torch_mxu_dft_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = run(m, B, device)
    res["card"] = smi
    print(json.dumps({"mxu_dft_probe": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
