#!/usr/bin/env python3
"""Identities of the polynomial layer at 2^k rows (default k = 22), the
port of examples/probe_k22.py; chip_smoke.py's `large` phase imports the
functions.

    python3 examples/torch_probe_k22.py [--k 22] [--device cuda]

  A  NTT round trip: inverse(forward(x)) == x
  B  KZG identity: commit(coeffs) == commit_lagrange(forward(coeffs))
     (the MSM, the NTT and both bases of the SRS in one check)
  C  Kate identity: q = kate(p, b); p(z) - p(b) == q(z) * (z - b) at a
     random z (the Kate division and the evaluation tables at size)
  S  the streamed extended inverse transform against the monolithic one
     at 2^(k+1): equal word for word, with each one's peak bytes above
     what was allocated before it (its input's copy included)
  M  the quotient pieces' commitment (vanishing.construct) at 2^k: peak
     bytes of one commit_many over two pieces against one piece at a time

Prints one JSON line per identity, then the card's name and power limit;
exits 1 unless every identity holds.  On the card the seconds and peaks
are device numbers; `--device cpu` runs the plain versions (small k only).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P  # noqa: E402
from halo2_tpu_torch.fields.bn254 import fr  # noqa: E402
from halo2_tpu_torch.ntt.ntt import NTT, get_ntt  # noqa: E402
from halo2_tpu_torch.poly.arith import eval_poly, kate_division  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402
from halo2_tpu_torch.utils.device import require_device  # noqa: E402


def measured(fn, device):
    """(fn(), seconds, peak allocated bytes above the bytes allocated
    before, peak reserved bytes); the two peaks are None off the card."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    if not cuda:
        return out, seconds, None, None
    return (out, seconds, torch.cuda.max_memory_allocated(device) - base,
            torch.cuda.max_memory_reserved(device))


def random_column(k: int, device, seed: int = 0):
    """(16, 2^k) Montgomery limbs of canonical values below 2^62."""
    vals = np.random.RandomState(seed).randint(
        0, 1 << 62, size=(1, 1 << k)).astype(np.uint64)
    return fr(device).encode_u64_dev(vals)[:, 0, :]


def identity_a(ntt: NTT, x) -> dict:
    """NTT round trip."""
    rt, s, peak, _ = measured(lambda: ntt.inverse(ntt.forward(x)), x.device)
    return {"identity": "A ntt round trip", "n": ntt.n,
            "ok": bool(torch.equal(rt, x)), "seconds": s,
            "peak_allocated_bytes": peak}


def identity_b(params: Params, ntt: NTT, coeffs) -> dict:
    """commit(coeffs) == commit_lagrange(forward(coeffs))."""
    def run():
        lag = ntt.forward(coeffs)
        return (params.commit_many_affine([coeffs])[0],
                params.commit_many_affine([lag], base="lagrange")[0])
    (c1, c2), s, peak, _ = measured(run, coeffs.device)
    return {"identity": "B kzg", "n": ntt.n, "ok": c1 == c2, "seconds": s,
            "peak_allocated_bytes": peak}


def identity_c(coeffs, seed: int = 1) -> dict:
    """The Kate identity at a random b and z."""
    rng = random.Random(seed)
    b, z = rng.randrange(1, P), rng.randrange(1, P)

    def run():
        q = kate_division(coeffs, b)
        return (eval_poly(coeffs, z), eval_poly(coeffs, b),
                eval_poly(q, z))
    (p_z, p_b, q_z), s, peak, _ = measured(run, coeffs.device)
    ok = (p_z - p_b) % P == q_z * ((z - b) % P) % P
    return {"identity": "C kate", "n": coeffs.shape[-1], "ok": ok,
            "seconds": s, "peak_allocated_bytes": peak}


def streamed_against_monolithic(ntt_ext: NTT, x, chunks_log: int = 3):
    """inverse_streamed_nodiv against inverse_nodiv on the same column,
    each handed a copy of it (so each lets its input go); the tables are
    built before, so each peak is the transform's input copy and working
    set."""
    ntt_ext._tables(True)
    mono, s_m, peak_m, _ = measured(
        lambda: ntt_ext.inverse_nodiv([x.clone()]), x.device)
    streamed, s_s, peak_s, _ = measured(
        lambda: ntt_ext.inverse_streamed_nodiv([x.clone()], chunks_log),
        x.device)
    return {"identity": "S streamed extended iNTT", "n": ntt_ext.n,
            "chunks_log": chunks_log, "ok": bool(torch.equal(mono, streamed)),
            "seconds": {"monolithic": s_m, "streamed": s_s},
            "peak_allocated_bytes": {"monolithic": peak_m,
                                     "streamed": peak_s}}


def piece_commit_peaks(params: Params, pieces: int = 2) -> dict:
    """The quotient pieces' commitment: one commit_many over `pieces`
    columns against one column at a time, the same bytes."""
    cols = [random_column(params.k, params.device, seed=10 + i)
            for i in range(pieces)]
    together, s_t, peak_t, _ = measured(
        lambda: params.commit_many_affine(cols), params.device)
    apart, s_a, peak_a, _ = measured(
        lambda: [params.commit_many_affine([c])[0] for c in cols],
        params.device)
    return {"identity": "M quotient pieces' commitment", "n": params.n,
            "pieces": pieces, "ok": together == apart,
            "seconds": {"together": s_t, "one_at_a_time": s_a},
            "peak_allocated_bytes": {"together": peak_t,
                                     "one_at_a_time": peak_a}}


def run_all(k: int, device, seed: int = 7) -> list:
    """Every identity at 2^k (S at 2^(k+1)); returns their records."""
    x = random_column(k, device)
    ntt = get_ntt(k, device)
    params = Params.unsafe_setup(k, seed=seed, device=device)
    out = [identity_a(ntt, x), identity_b(params, ntt, x), identity_c(x)]
    ext = get_ntt(k + 1, device)
    out.append(streamed_against_monolithic(ext, random_column(k + 1, device)))
    ext.drop_tables()
    out.append(piece_commit_peaks(params))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=22)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = require_device(args.device)
    records = run_all(args.k, device)
    for rec in records:
        print(json.dumps(rec), flush=True)
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        print(smi.stdout.strip().splitlines()[0])
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
