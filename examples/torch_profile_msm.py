#!/usr/bin/env python3
"""Stage-level MSM profile on the card (the port's examples/profile_msm.py).

    python3 examples/torch_profile_msm.py [--k K] [--ns 16,64,...]
                                          [--label TEXT] [--golden]

Every time is device ms: N calls captured once in a CUDA graph and
replayed between CUDA events (`utils.profiling.time_graph`), no host in
the way.  A stage's time is the difference of two cumulative prefixes of
one path, as in the JAX package's profile.  Prints one JSON line a
measurement:

  * `sorted`, at n = 2^K (default 16), full 254-bit scalars: the sorted
    path's stages (msm/sorted.py `window_totals`, then the Horner combine)
      S1  digits + sort + packed point rows
      S2  + the bucket scan (`msm_scan`: the n * W mixed adds)
      S3  + the blocks' exclusive scan, the bucket boundaries and the Abel
          fold (= `window_totals` complete)
      S4  + the Horner combine over the windows (the whole MSM);
  * `bucket`, at each n of --ns (default 16, 64, 256, 512, 1024, 2047),
    with full and with 16-bit scalars: the bucket path's stages (msm/msm.py
    `_bucket_totals`, then Horner at c = 8)
      B1  from Montgomery form + the 8-bit digits
      B2  + the `msm_bucket` kernel (buckets, their reduction; the lanes
          are merged inside it)
      B3  + the totals padded to one window count
      B4  + the Horner combine (the whole MSM),
    the kernel alone, and the sorted path's whole MSM at the same n and
    scalars, so the two paths compare in one run;
  * then the same as a text table, a line a measurement;
  * with --golden instead: the seconds of a warm `create_proof` of each
    golden circuit of tests/data (SimpleCircuit at K = 4 with seed 0,
    LookupShuffle and RangeCheck at K = 5, AllArgs at K = 9), best of 3.
    That mode calls only functions every tree of the port has, so a copy of
    an older tree can run it in the same call: parent, change, change,
    parent.

Needs one CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from halo2_tpu_torch.curves import g1  # noqa: E402
from halo2_tpu_torch.fields.limbs import N_LIMBS  # noqa: E402
from halo2_tpu_torch.utils import profiling  # noqa: E402

NS = (16, 64, 256, 512, 1024, 2047)


def _points_and_scalars(n, bits, gen, device):
    """n affine points k_i * G (fixed-base comb, k_i random, never 0) and
    n random Montgomery scalars below 2^bits (16 or 254); full scalars are
    canonical and uniform below r's top limb, as a commitment's values are
    (the top window's digits then fill buckets 0 .. 0x30 evenly)."""
    from halo2_tpu_torch.fields.bn254 import FR_MODULUS, fr
    k = torch.randint(0, 1 << 16, (N_LIMBS, n), dtype=torch.int32,
                      device=device, generator=gen)
    k[N_LIMBS - 1] &= 0x0FFF
    k[0] |= 1
    pts = g1.to_affine(g1.fixed_base_mul(k))
    s = torch.randint(0, 1 << 16, (N_LIMBS, n), dtype=torch.int32,
                      device=device, generator=gen)
    s[-(-bits // 16):] = 0
    if bits >= 254:
        s[N_LIMBS - 1] = torch.randint(0, FR_MODULUS >> 240, (n,),
                                       dtype=torch.int32, device=device,
                                       generator=gen)
    return pts, fr(device).to_mont(s)


def _stages(prefixes, reps):
    """{name: device ms of the stage}, from the cumulative prefixes."""
    cum = [(name, profiling.time_graph(fn, reps)) for name, fn in prefixes]
    out, prev = {}, 0.0
    for name, t in cum:
        out[name] = t - prev
        prev = t
    return out, cum[-1][1]


def sorted_profile(k, gen, device, reps):
    from halo2_tpu_torch.fields.bn254 import fr
    from halo2_tpu_torch.msm import msm, sorted as ms
    n = 1 << k
    (px, py), scal = _points_and_scalars(n, 254, gen, device)
    block = msm._block_for(n)
    c = msm.window_bits_for(block)
    W = ms.num_windows_for(256, c)
    group = ms.auto_group(n, W)
    nb = (1 << (c - 1)) + 1

    def s1():
        mag, neg = ms._signed_digits(fr(device).from_mont(scal), W, c)
        key, order = torch.sort((mag[:group] << 1) | neg[:group], dim=1,
                                stable=True)
        return ms.pack_xy(px, py).t().contiguous(), order, key

    def s2():
        rows, order, key = s1()
        from halo2_tpu_torch.curves import cuda_point
        return cuda_point.msm_scan(rows, order, key, block, nb)

    def s3():
        return ms.window_totals(px, py, scal, 256, group, block, c)

    def s4():
        return msm._combine_windows(s3(), c)

    stages, total = _stages([("S1 digits+sort+rows", s1),
                             ("S2 +scan", s2), ("S3 +reduce", s3),
                             ("S4 +combine", s4)], reps)
    return {"path": "sorted", "n": n, "bits": 254, "c": c, "windows": W,
            "group": group, "block": block,
            "stages_ms": stages, "total_ms": total,
            "note": "S1-S3 cover the first window group"
                    if group < W else "one window group"}


def bucket_profile(n, bits, gen, device, reps):
    from halo2_tpu_torch.curves import cuda_point
    from halo2_tpu_torch.fields.bn254 import fr
    from halo2_tpu_torch.msm import msm
    (px, py), scal = _points_and_scalars(n, bits, gen, device)
    W = msm.bucket_windows(bits)
    lanes = msm._pick_lanes(n)

    def b1():
        return msm._digits(fr(device).from_mont(scal), W)

    def b2():
        return cuda_point.msm_bucket(px, py, b1(), lanes)

    def b3():
        return msm._bucket_totals(px, py, [scal], [bits], lanes)

    def b4():
        return msm._combine_windows(b3(), msm.C_BITS)

    stages, total = _stages([("B1 digits", b1), ("B2 +kernel", b2),
                             ("B3 +pad windows", b3),
                             ("B4 +combine", b4)], reps)
    digits = b1()
    kernel = profiling.time_graph(
        lambda: cuda_point.msm_bucket(px, py, digits, lanes), reps)
    block = msm._block_for(n)
    c = msm.window_bits_for(block)

    def sorted_path():
        return msm._combine_windows(
            msm.column_totals(px, py, [scal], [bits], block), c)
    sorted_ms = profiling.time_graph(sorted_path, reps)
    if not torch.equal(torch.stack(g1.to_affine(b4())),
                       torch.stack(g1.to_affine(sorted_path()))):
        raise AssertionError(f"the bucket and sorted paths differ at n = {n}")
    return {"path": "bucket", "n": n, "bits": bits, "windows": W,
            "lanes": lanes, "stages_ms": stages, "total_ms": total,
            "kernel_ms": kernel, "sorted_total_ms": sorted_ms,
            "sorted_c": c, "affine_equal": True}


def golden_profile(device, tries=3):
    """Warm create_proof seconds of each golden circuit (functions every
    tree of the port has)."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "data"))
    from torch_golden_circuits import argument_circuit
    from halo2_tpu_torch.circuits import SimpleCircuit
    from halo2_tpu_torch.plonk.keygen import keygen
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.poly.commitment import Params
    with open(os.path.join(ROOT, "tests", "data",
                           "torch_golden_args.json")) as fh:
        records = json.load(fh)["proofs"]
    cases = [("simple", 4, 1, SimpleCircuit(3, 5), None,
              [[SimpleCircuit.expected_out(3, 5)]], 0)]
    for name, rec in records.items():
        circuit, planner = argument_circuit(name, rec["k"])
        cases.append((name, rec["k"], rec["params_seed"], circuit, planner,
                      rec["instances"], rec["prover_seed"]))
    out = {}
    for name, k, pseed, circuit, planner, instances, seed in cases:
        params = Params.unsafe_setup(k, seed=pseed, device=device)
        vk, pk = keygen(params, circuit, floor_planner=planner,
                        device=device)
        prove = lambda: create_proof(  # noqa: E731
            params, pk, circuit, instances, seed=seed, floor_planner=planner,
            device=device)
        prove()                             # warm up
        times = []
        for _ in range(tries):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            prove()
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        out[name] = {"k": k, "create_proof_s": min(times),
                     "create_proof_s_all": times}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--ns", default=",".join(map(str, NS)))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--golden", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_msm.py needs a CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    head = {"label": args.label, "card": smi}
    if args.golden:
        print(json.dumps({**head, "golden": golden_profile(device)}),
              flush=True)
        return
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    rows = [sorted_profile(args.k, gen, device, args.reps)]
    print(json.dumps({**head, **rows[0]}), flush=True)
    for n in (int(x) for x in args.ns.split(",")):
        for bits in (254, 16):
            rows.append(bucket_profile(n, bits, gen, device, args.reps))
            print(json.dumps({**head, **rows[-1]}), flush=True)
    print(f"{smi}: device ms")
    for r in rows:
        stages = " | ".join(f"{k} {v:.4f}" for k, v in r["stages_ms"].items())
        tail = (f" | sorted {r['sorted_total_ms']:.4f}"
                if r["path"] == "bucket" else "")
        print(f"{r['path']} n={r['n']} bits={r['bits']}: {stages} | total "
              f"{r['total_ms']:.4f}{tail}")


if __name__ == "__main__":
    main()
