#!/usr/bin/env python3
"""The small-MSM bucket kernel (`cuda_point.msm_bucket`) on the card.

    python3 examples/torch_bucket_probe.py [--label TEXT] [--variants]

Times `msm_bucket` of the tree it sits in at chip_smoke.py's shapes (the
golden K = 9 proof's widest commitment batch, n = 512 and 160 rows; the
K = 4 proof's n = 16, 32 rows; n = 2047 with 254-bit scalars, with
canonical ones below r and with 16-bit ones), each held exactly (affine)
to its plain version, and prints one JSON line: the card, the kernel's
registers, stack and spills (ptxas), blocks a SM, and the device ms of
each shape (20 launches captured in a CUDA graph; `profiling.time_graph`).
It calls only what every tree of the port with the bucket path has, so a
copy of an older tree runs it too (copy the file into its `examples/`):
parent, change, change, parent in one call.

With --variants, for the tree's own csrc/point_kernels.cu: copies of it,
each changed at a named place, built by nvcc into `_build/probe/`, timed
the same way (a line each):
  * `blocks_256`, `blocks_128`: a block of 256, of 128 threads a row at
    every row count;
  * `blocks_256_two_a_sm`: the same under __launch_bounds__(256, 2), 128
    registers, so that two blocks fit a SM;
  * `one_product_a_call`: the one-thread adds by fq_mul alone, no
    fq_mul2;
and `stamps`: the kernel with clock64() read by thread 0 of block 0 after
each phase of its first row, printed as SM cycles a phase (sort, fill,
chains, chain writes, radix rounds 1 and 2, rounds 3 and 4, bit planes,
their weighted sum).  A variant whose anchor text is missing fails.

Needs one CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from halo2_tpu_torch.curves import cuda_point, g1  # noqa: E402
from halo2_tpu_torch.fields.bn254 import FR_MODULUS  # noqa: E402
from halo2_tpu_torch.fields.limbs import N_LIMBS  # noqa: E402
from halo2_tpu_torch.msm import msm  # noqa: E402
from halo2_tpu_torch.utils import build, profiling  # noqa: E402

# (name, n, columns, scalars): 254 = 254-bit (top byte to 0x3F),
# "canonical" = below r (top byte to 0x30), 16 = 16-bit
SHAPES = (("golden K=9", 512, 5, 254), ("K=4", 16, 1, 254),
          ("2047", 2047, 1, 254), ("2047 canonical", 2047, 1, "canonical"),
          ("2047 16-bit", 2047, 1, 16))

# a variant: the source's text and what takes its place
LAUNCH = "rows > sms ? NB / 2 : NB,"
BOUNDS = "__global__ void __launch_bounds__(NB) msm_bucket_kernel("
VARIANTS = {
    "blocks_256": [(LAUNCH, "NB,")],
    "blocks_128": [(LAUNCH, "NB / 2,")],
    "blocks_256_two_a_sm": [
        (LAUNCH, "NB,"),
        (BOUNDS, BOUNDS.replace("(NB)", "(NB, 2)"))],
    "one_product_a_call": [
        ("  return add_complete_ilp(p, q);\n}",
         "  return add_complete(p, q);\n}"),
        ("  return add_mixed_ilp(p, x, y);", "  return add_mixed(p, x, y);")],
}
# the stamps: (text a stamp goes before, phase that it ends); each is
# reached right after a __syncthreads, so the phase is the block's
STAMP_AT = (
    ("      // the fill: thread t sums", "sort"),
    ("      const int span = sm.span;", "fill"),
    ("      // a bucket that ends with the run", "chains"),
    ("    // the reduction; rounds 1 and 2", "chain writes"),
    ("    for (int it = t; it < NB / 2; it += T) {", "round 1"),
    ("    // rounds 3 (64 adds) and 4 (32)", "round 2"),
    ("    // C_h in slots 0..15", "rounds 3-4"),
    ("    // sum_j 2^j F_j", "bit planes"),
)
ROW_START = "    const int32_t* dig = digits + (int64_t)r * n;\n"
ROW_END = ("    __syncthreads();" + " " * 26
           + "// the slots of the next row\n")


def _stamp(k):
    return (f"    if (blockIdx.x == 0 && r == (int)blockIdx.x && "
            f"threadIdx.x == 0) probe_stamps[{k}] = clock64();\n")


def _patched(src, name):
    if name == "stamps":
        edits = [(ROW_START, ROW_START + _stamp(0))]
        edits += [(at, _stamp(k + 1) + at)
                  for k, (at, _) in enumerate(STAMP_AT)]
        edits += [(ROW_END, ROW_END + _stamp(len(STAMP_AT) + 1))]
        edits += [("constexpr int NB = 256;",
                   "__device__ long long probe_stamps[16];\n"
                   "constexpr int NB = 256;"),
                  ('}  // extern "C"',
                   "int probe_read_stamps(long long* dst) {\n"
                   "  return (int)cudaMemcpyFromSymbol(dst, probe_stamps,\n"
                   + " " * 35 + "sizeof(probe_stamps));\n"
                   '}\n\n}  // extern "C"')]
    else:
        edits = VARIANTS[name]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: anchor not found once: "
                               f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_variants(names):
    """{name: (loaded library, ptxas usage)}, all nvcc builds at once."""
    out_dir = os.path.join(build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(build.CSRC_DIR, "point_kernels.cu")) as f:
        src = f.read()
    procs = {}
    for name in names:
        cu = os.path.join(out_dir, f"point_kernels_{name}.cu")
        with open(cu, "w") as f:
            f.write(_patched(src, name))
        lib = os.path.join(out_dir, f"libpoint_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR,
             "-o", lib, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = (cuda_point.typed(ctypes.CDLL(lib)), _usage(log))
    return libs


def _usage(log):
    """Registers, stack and spill bytes of msm_bucket_kernel in a log."""
    out, mine = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            mine = "msm_bucket_kernel" in line
        elif mine and "bytes stack frame" in line:
            w = line.split()
            out.update(stack_bytes=int(w[0]), spill_stores=int(w[4]),
                       spill_loads=int(w[8]))
        elif mine and "Used" in line and "registers" in line:
            out["registers"] = int(line.split("Used", 1)[1].split()[0])
    return out


def _inputs(gen, device, aff):
    for name, n, cols, kind in SHAPES:
        digits = []
        for _ in range(cols):
            s = torch.randint(0, 1 << 16, (N_LIMBS, n), dtype=torch.int32,
                              device=device, generator=gen)
            if kind == "canonical":
                s[N_LIMBS - 1] = torch.randint(
                    0, FR_MODULUS >> 240, (n,), dtype=torch.int32,
                    device=device, generator=gen)
            elif kind == 254:
                s[N_LIMBS - 1] &= 0x3FFF
            else:
                s[kind // 16:] = 0
            bits = 254 if kind == "canonical" else kind
            digits.append(msm._digits(s, msm.bucket_windows(bits)))
        d = torch.cat(digits)
        yield name, aff[0][:, :n].contiguous(), aff[1][:, :n].contiguous(), d


def _plain(px, py, d, aff):
    """The plain version in affine, its n padded to 64 lanes (the padding
    points under zero digits)."""
    n = px.shape[1]
    m = -(-n // 64) * 64
    pp = [torch.cat([c, a[:, :1].expand(N_LIMBS, m - n)], 1)
          for c, a in zip((px, py), aff)]
    d = torch.nn.functional.pad(d, (0, m - n))
    return torch.stack(g1.to_affine(cuda_point.plain_msm_bucket(*pp, d, 64)))


def _launcher(lib):
    def run(px, py, d):
        out = tuple(torch.empty((N_LIMBS, d.shape[0]), dtype=torch.int32,
                                device=px.device) for _ in range(3))
        build.launch(px.device, lib.h2_msm_bucket, px.data_ptr(),
                     py.data_ptr(),
                     d.data_ptr(), px.shape[1], d.shape[0],
                     *[o.data_ptr() for o in out])
        return out
    return run


def _measure(run, shapes, want, stamps_of=None):
    res = []
    for (name, px, py, d), w in zip(shapes, want):
        got = torch.stack(g1.to_affine(run(px, py, d)))
        row = {"shape": f"{name} rows={d.shape[0]}",
               "exact": bool(torch.equal(got, w)),
               "device_ms": profiling.time_graph(lambda: run(px, py, d))}
        if stamps_of is not None:
            run(px, py, d)
            torch.cuda.synchronize()
            row["cycles"] = stamps_of()
        res.append(row)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bucket_probe needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    built = build.build_all()
    usage = {}
    for log in built["logs"].values():
        usage.update(_usage(log))
    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    # n points k_i * G, k_i random 16-bit
    base = g1.generator(device)
    k = torch.zeros((N_LIMBS, 2048), dtype=torch.int32, device=device)
    k[0] = torch.randint(1, 1 << 16, (2048,), dtype=torch.int32,
                         device=device, generator=gen)
    aff = g1.to_affine(g1.scalar_mul(
        tuple(c[:, None].expand(N_LIMBS, 2048).contiguous() for c in base),
        k))
    shapes = list(_inputs(gen, device, aff))
    want = [_plain(px, py, d, aff) for _, px, py, d in shapes]
    line = {"label": args.label, "card": smi, **usage,
            "blocks_per_sm": {k: v for k, v in cuda_point.occupancy().items()
                              if k.startswith("msm_bucket")},
            "shapes": _measure(lambda px, py, d: cuda_point.msm_bucket(
                px, py, d, 1), shapes, want)}
    print(json.dumps(line), flush=True)
    if not args.variants:
        return
    names = list(VARIANTS) + ["stamps"]
    for name, (lib, use) in _build_variants(names).items():
        stamps_of = None
        if name == "stamps":
            def stamps_of(lib=lib):
                buf = (ctypes.c_longlong * 16)()
                if lib.probe_read_stamps(buf) != 0:
                    raise RuntimeError("probe_read_stamps failed")
                st = list(buf)[:len(STAMP_AT) + 2]
                phases = [p for _, p in STAMP_AT] + ["weighted sum"]
                return {p: st[i + 1] - st[i] for i, p in enumerate(phases)}
        print(json.dumps({"label": args.label, "variant": name, **use,
                          "shapes": _measure(_launcher(lib), shapes, want,
                                             stamps_of)}), flush=True)


if __name__ == "__main__":
    main()
