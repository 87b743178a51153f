#!/usr/bin/env python3
"""Smoke run of halo2_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--k K]
                          [--phases env,kernels,golden,prove,args,multi,synth,
                                    large,mesh,dft]

Builds the CUDA kernels from halo2_tpu_torch/csrc and the host codec from
halo2_tpu_torch/native, then:

  kernels  holds every kernel against its plain PyTorch version on the card
           (exact equality of the limb words: the tolerance is zero), at the
           shapes the k-row proof of each driven path (prove, args, multi)
           gives it and at ragged ones, and times it with CUDA events
           beside its bound: `ms` around 20 launches from Python,
           `device_ms` from the same 20 launches replayed from a CUDA
           graph.  The chain entry
           points (pow, inv, the prefix-product scan, the MSM's bucket
           scan, the Horner combine, the scalar ladder, the fixed-base
           comb) are held to their composed plain versions at the proofs'
           shapes (pow and the comb also at the large path's 2^22) and at
           edge cases,
           and each public function is shown to make its one launch; K2
           and K3 also at the chunk shapes
           the streamed extended inverse transform of the large path feeds
           them; the small MSM's bucket kernel (`msm_bucket`) against its
           plain lane-private buckets exactly after to_affine, at n = 1,
           7, 16, 32, 512 and 2047, full and 16-bit scalars, 1, 4 and 64
           lanes, and at 2047 with canonical scalars (the top window's
           buckets crowded), timed at the golden proofs' shapes and at
           2047 with both scalars, the kernel's own count of its adds
           (`kernel_adds`) printed beside the function's
           (`complete_adds`, which sets the bound), and msm_many's bucket
           path against its sorted path; the decode of canonical 32-byte
           rows (`decode_le32`) against its plain version, limbs and each
           column's stats, at C n = 1, 7, 2^16 + 3, 3 x 2^20, 2^21 and
           3 x 2^22, masked and unmasked, a row >= p planted in one run,
           timed at the last three beside its bound by bytes and the
           pinned upload of the same rows, and its staged path twice
           before any wait;
  golden   with the sanity checks (HALO2_TPU_SANITY_CHECKS) and the span
           profiler (synchronising) on, and the launch counts set to 0
           just before and read just after (every MSM there is below 2048
           points: `msm_bucket` launches, `msm_scan` does not; the
           report's first lines printed),
           proves tests/data/torch_golden_proof.json's circuit (K = 4) with
           its seeds, each circuit of tests/data/torch_golden_args.json
           (a logup lookup over two input sets and a shuffle, K = 5; a range
           check, K = 5; every argument, K = 9) with its seed, and every
           proof of tests/data/torch_golden_multi.json (two-instance GWC and
           SHPLONK proofs, single SHPLONK proofs, K = 4 and 5, and the proof
           from the JAX package's witness file), and compares the pinned
           vks and the proof bytes; the port's verifier must accept each;
  prove    unsafe_setup -> keygen -> create_proof -> verify_proof for a
           row-filling chain of mul gates at 2^k rows, with every kernel's
           launch count set to 0 just before and read just after (all
           counters printed, with the K1 and K4 family totals; the MSM's
           bucket scan launched once a window group, the Horner kernel once
           a call, the fixed-base comb twice (setup's two bases), the 1:1
           scan step `add_mixed_packed`, the scalar ladder and `pow` never:
           every inversion is `inv`'s; `msm_bucket` never from 2^11 rows
           on, `msm_scan` never below), setup's seconds by phase; a proof
           with one byte flipped and a wrong instance must be rejected;
  args     the same for AllArgsCircuit over every usable row of 2^k (gate
           with a compressed selector, permutation, a shared-table logup
           lookup with two input sets, a shuffle of two units, a range
           check), proved with FlatFloorPlanner, with the same checks and
           the peak device memory;
  multi    two AllArgsCircuit instances (witness seeds 5 and 6) at 2^k rows
           in one SHPLONK proof (create_proof_multi), with the same counts
           and checks (the instances swapped must be rejected, and
           BatchVerifier must accept); then the file round trip: params,
           circuit data, vk and instance 0's witness written and read back
           into a fresh Params and ProvingKey, create_proof_from_witness
           against create_proof on the in-memory key (same seed, SHPLONK),
           and the reloaded vk verifying the proof; the loads are the
           `load` path, with the counts set to 0 just before and read just
           after (`pow`, the square roots of the params' points, at least
           once);
  synth    BlockMulChainCircuit (a chain of mul gates, a step a row, in 64
           regions handed to layouter.assign_regions) at 2^k rows: keygen
           on the card, then its regions synthesized by forked workers
           (default_workers()), proved and verified with the same counts and
           checks; then synthesize_witness alone with 1 and with W workers
           (seconds of each, equal columns), the proof of one worker equal
           to the W workers' proof, their witness files equal, and the
           degraded (>= 2^64) column's export by the host codec equal to the
           plain Python join (seconds of each);
  large    MulChainCircuit at 2^22 rows (whatever --k is) through the
           large-domain sequence: create_proof(offload_lagrange=True), with
           the seconds and the peak allocated and reserved bytes of every
           phase, the same counts and checks as prove, and the counters
           showing the streamed extended iNTT and the offloads ran; then
           the identities of examples/torch_probe_k22.py at that size (NTT
           round trip, KZG, Kate) and the streamed extended inverse
           transform against the monolithic one at 2^23, equal
           word for word, each with its peak bytes;
  mesh     AllArgsCircuit at 2^k rows over a mesh of 4 shards placed on
           cuda:(i % device_count) (params.use_mesh: the sharded MSMs, the
           four-step iNTTs, the row-sharded h evaluator, the quotient's
           transform over the mesh): first DistNTT at the args path's
           extended size (forward, inverse, inverse_nodiv), the sharded MSM
           over 2^16 points (full and 16-bit scalars) and dist_roll on
           every (q, r) branch, each against its single-device counterpart
           exactly; then setup, keygen and the sharded proof with the
           launch counts set to 0 just before and read just after, every
           field, transform and point wrapper at each shape it was called
           with there held to its plain version, the proof's bytes equal
           to the single-device proof of the same seed, the port's
           verifier and BatchVerifier accepting it and a tampered copy
           rejected; seconds by phase of the sharded (cold and warm) and
           the single proof, peak allocated bytes per device, and a line
           saying whether shard copies crossed cards;
  dft      the tensor-core DFT probe (examples/torch_mxu_dft_probe.py) at
           m = 16 and 64, B = 2^17: dft_matmul with the launch counts set
           to 0 just before and read just after, its output against the host
           big-int DFT mod p (all-0xFF inputs among the columns) and against
           the CIOS NTT, kernel K6 against its plain version exactly (the
           probe's sums, a ragged B, the largest and the zero sums), and the
           probe's times beside their bounds.

Prints one JSON object per phase, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}.  Any failure is a non-zero
exit; without a CUDA card the script exits before printing any result.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from halo2_tpu_torch import io as h2io
from halo2_tpu_torch import native
from halo2_tpu_torch.circuit import FlatFloorPlanner
from halo2_tpu_torch.circuits import (AllArgsCircuit, BlockMulChainCircuit,
                                      MulChainCircuit, SimpleCircuit)
from halo2_tpu_torch.curves import cuda_point, g1
from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P, fq, fr
from halo2_tpu_torch.fields.limbs import (N_LIMBS, ints_to_limbs_np,
                                          limbs_to_ints)
from halo2_tpu_torch.msm import msm
from halo2_tpu_torch.msm import sorted as msm_sorted
from halo2_tpu_torch.msm.distributed import msm_many_sharded
from halo2_tpu_torch.msm.msm import SORT_BLOCK, msm_many, window_bits_for
from halo2_tpu_torch.multiopen import BatchVerifier
from halo2_tpu_torch.ntt import dft_matmul as dm
from halo2_tpu_torch.ntt.distributed import DistNTT
from halo2_tpu_torch.ntt.ntt import get_ntt
from halo2_tpu_torch.plonk import logup_prover, permutation, shuffle_prover
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.parallel_synthesis import default_workers
from halo2_tpu_torch.plonk.prover import (LARGE_N, create_proof,
                                          create_proof_from_witness,
                                          create_proof_multi, create_witness,
                                          synthesize_witness)
from halo2_tpu_torch.plonk.verifier import verify_proof, verify_proof_multi
from halo2_tpu_torch.poly.commitment import Params, setup_scalars
from halo2_tpu_torch.poly.domain import STREAM_NTT_MIN
from halo2_tpu_torch.utils import build, profiling
from halo2_tpu_torch.utils.profiling import bound_ms as _bound
from halo2_tpu_torch.utils.profiling import max_abs_err as _max_err
from halo2_tpu_torch.utils.mesh import Mesh, dist_roll
from halo2_tpu_torch.utils.profiling import time_cuda as _time_cuda
from examples import torch_probe_k22 as probe_k22
from tests.data.torch_golden_circuits import argument_circuit, multi_circuits

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_proof.json")
GOLDEN_ARGS = os.path.join(ROOT, "tests", "data", "torch_golden_args.json")
GOLDEN_MULTI = os.path.join(ROOT, "tests", "data", "torch_golden_multi.json")
DFT_PROBE = os.path.join(ROOT, "examples", "torch_mxu_dft_probe.py")

# 32-bit integer multiply-add-class instructions of one field operation, as
# the kernels issue them (csrc/field.cuh): a CIOS Montgomery product runs,
# for each of its 8 words, two rows of 8 low and 8 high multiply-adds
# (mad_row) and one product for m; a Montgomery square (mont_sqr) the 36
# distinct word products of a^2, low and high halves, and the same 8 rows of
# reduction; an add or sub is two 8-word carry chains (integer additions,
# counted at the same rate).
MADS_MUL = 8 * (2 * 16 + 1)
MADS_SQR = 2 * 36 + 8 * (16 + 1)
OPS_ADD = 16
# field products / additions of the point formulas (curves/formulas.py),
# and how many of the products are squares (y^2, z^2 of the doubling)
POINT_OPS = {"add": (12, 29), "add_mixed": (11, 25), "double": (8, 17)}
POINT_SQRS = {"add": 0, "add_mixed": 0, "double": 2}
WORD = 4


def _bounds(n_bytes, muls, adds=0, sqrs=0) -> dict:
    """The bound of `muls` field products, `sqrs` of them squares, and
    `adds` field additions on n_bytes, at the card's integer rate."""
    bound, by = _bound(n_bytes, (muls - sqrs) * MADS_MUL + sqrs * MADS_SQR
                       + adds * OPS_ADD)
    return {"bound_ms": bound, "bound_by": by}


def _entry(name, source, replaces, variants, shape) -> dict:
    """A kernels-line entry whose numbers are those of its first variant."""
    head = variants[0]
    e = {"name": name, "route": "cuda", "source": source,
         "replaces": replaces,
         "max_abs_err": max(v["max_abs_err"] for v in variants),
         "library_ms": None, "shape": shape, "variants": variants}
    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by"):
        e[key] = head[key]
    return e


def _times(fn, plain_ms, reps=20) -> dict:
    return {"ms": _time_cuda(fn, reps),
            "device_ms": profiling.time_graph(fn, reps), "plain_ms": plain_ms}


def _launches_of(fn) -> dict:
    """The launches fn makes, by counter (the counters are 0 before)."""
    _reset_counts()
    fn()
    counts = {**cuda_ops.launch_counts, **cuda_point.launch_counts}
    _reset_counts()
    return {k: v for k, v in counts.items() if v}


def _expect_launches(what, fn, want: dict):
    got = _launches_of(fn)
    if got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")


def _rand_field(F, shape, gen, specials=True):
    """Random canonical Montgomery-form elements with 0, 1 and p-1 among
    the first ones."""
    n = 1
    for d in shape:
        n *= d
    raw = torch.randint(0, 1 << 16, (N_LIMBS, n), dtype=torch.int32,
                        device=F.device, generator=gen)
    raw[N_LIMBS - 1] &= 0x0FFF               # below 2^252 < p
    if specials and n >= 3:
        raw[:, 0] = 0
        raw[:, 1] = F.encode_scalar(1)
        raw[:, 2] = F.encode_scalar(F.p - 1)
    return raw.reshape((N_LIMBS,) + tuple(shape))


def _rand_points(n, gen, device):
    """n affine points (x, y) and the same as projective with random Z:
    multiples of the generator made on the card by the point kernels."""
    Fq = fq(device)
    gen_aff = g1.generator(device)
    base = (gen_aff[0][:, None].expand(N_LIMBS, n).contiguous(),
            gen_aff[1][:, None].expand(N_LIMBS, n).contiguous())
    scal = torch.zeros((N_LIMBS, n), dtype=torch.int32, device=device)
    scal[:2] = torch.randint(1, 1 << 16, (2, n), dtype=torch.int32,
                             device=device, generator=gen)
    proj = g1.scalar_mul(base, scal)
    aff = g1.to_affine(proj)
    z = _rand_field(Fq, (n,), gen, specials=False)
    z[0] |= 1                                # never zero
    scaled = tuple(Fq.mul(c, z) for c in (proj[0], proj[1], proj[2]))
    return aff, scaled


def phase_env(out):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    built = build.build_all()
    t0 = time.time()
    native.lib()                             # the host codec, built by g++
    codec_s = time.time() - t0
    ptxas = {}
    for log in built["logs"].values():
        ptxas.update(build.ptxas_usage(log))
    out["smi"] = smi.stdout.strip().splitlines()[0]
    out["ptxas"] = ptxas
    env = {"nvidia_smi": out["smi"], "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "nvcc": nvcc.stdout.strip().splitlines()[-2:],
           "build_seconds": round(built["seconds"], 2),
           "codec_build_seconds": round(codec_s, 2),
           "int_rate": profiling.card_int_rate(), "ptxas": ptxas}
    print(json.dumps({"env": env}), flush=True)


# the circuit of each driven path, for the shapes its k-row proof gives
# the kernels (configured only: no witness), the instances a proof and
# whether it opens with SHPLONK
PATH_CIRCUITS = (("prove", lambda: MulChainCircuit(1), 1, False),
                 ("args", lambda: AllArgsCircuit(), 1, False),
                 ("multi", lambda: AllArgsCircuit(), 2, True),
                 ("synth", lambda: BlockMulChainCircuit(1, 1), 1, False))
# the witness seeds of the multi path's two AllArgsCircuit instances
MULTI_SEEDS = (5, 6)
# the large path's rows (2^LARGE_K, MulChainCircuit) and the lane chunks
# of its streamed extended inverse transform
LARGE_K = 22
STREAM_CHUNKS_LOG = 3


def _shplonk_sets(cs, proofs: int) -> dict:
    """The commitments of each SHPLONK rotation set of a proof of `proofs`
    instances of a circuit (the prover's query stream): {rotations: count}.
    """
    last = -(cs.blinding_factors() + 1)
    sets = {}

    def add(rots, count):
        key = tuple(sorted(set(rots)))
        sets[key] = sets.get(key, 0) + count

    for queries, per in ((cs.instance_queries, proofs),
                         (cs.advice_queries, proofs), (cs.fixed_queries, 1)):
        rots = {}
        for col, rot in queries:
            rots.setdefault(col.index, set()).add(rot)
        for r in rots.values():
            add(r, per)
    products = -(-len(cs.permutation.columns) // (cs.degree() - 2))
    chains = [products] + [len(lk.input_expressions_sets)
                           for lk in cs.lookups]
    for zs in chains:
        if zs:
            add((last, 0, 1), proofs * (zs - 1))
            add((0, 1), proofs)
    add((0,), len(cs.permutation.columns) + 2 + proofs * len(cs.lookups))
    add((0, 1), proofs * len(cs.shuffles))
    return {rots: c for rots, c in sets.items() if c}


def _shapes(k: int, path: str, circuit, proofs: int = 1,
            shplonk: bool = False):
    """The shapes the k-row proof of `proofs` instances of `circuit` gives
    each kernel."""
    cs = ConstraintSystem()
    circuit.configure(cs)
    cs.chunk_lookups()
    cs.chunk_shuffles()
    cs_degree = cs.degree()
    dom_k = k
    qd = max(cs_degree - 1, 1)
    ext_k = dom_k
    while (1 << ext_k) < (1 << dom_k) * qd:
        ext_k += 1
    n, ext_n = 1 << k, 1 << ext_k
    block = min(SORT_BLOCK, n)
    c = window_bits_for(block)
    windows = msm_sorted.num_windows_for(254, c)
    sets = [lk.input_expressions_sets for lk in cs.lookups]
    # the widest commitment batch (one msm_many, one Horner lane a column):
    # keygen's fixed columns (selectors included) or permutation columns,
    # every proof's advice, instance or m columns, the quotient's pieces,
    # every proof's lookup zs (one a set) and shuffle zs; the
    # permutation's grand products are at most one a permutation column
    lanes = max(cs.num_fixed_columns + cs.num_selectors,
                len(cs.permutation.columns), proofs * cs.num_advice_columns,
                proofs * cs.num_instance_columns, qd, proofs * len(sets),
                proofs * (sum(len(s) for s in sets) + len(cs.shuffles)))
    # K1's column batches: the commitment batch, and SHPLONK's fold of its
    # largest rotation set, (16, Q, n)
    batches = [lanes]
    if shplonk:
        batches.append(max(_shplonk_sets(cs, proofs).values()))
    # prefix_mul's lengths (batch_inverse): a column of n, and the logup
    # grand sums' inverses, C inputs and the table of a lookup's first set,
    # C inputs of each further set
    scan = {n}
    for lk_sets in sets:
        scan.add((len(lk_sets[0]) + 1) * n)
        scan.update(len(s) * n for s in lk_sets[1:])
    return {"path": path, "k": k, "n": n, "ext_n": ext_n, "ext_k": ext_k,
            "scan": windows * block, "windows": windows, "c": c,
            "block": block, "nb": (1 << (c - 1)) + 1,
            "horner_lanes": lanes, "batches": batches,
            "prefix_lengths": sorted(scan)}


def _other_paths(shs, key) -> list:
    """The shapes of every path after the first whose `key` differs from
    the first path's."""
    return [sh for sh in shs[1:] if sh[key] != shs[0][key]]


def _k1_binop(shs, gen, device) -> dict:
    sh = shs[0]
    ext_ns = sorted({x["ext_n"] for x in shs}, reverse=True)
    variants = []
    for F in (fr(device), fq(device)):
        for op in ("add", "sub", "mul"):
            worst = 0
            for n in ext_ns + [1000, 1]:
                a = _rand_field(F, (n,), gen)
                b = _rand_field(F, (n,), gen).flip(1).contiguous()
                worst = max(worst, _max_err(
                    cuda_ops.binop(op, F, a, b),
                    cuda_ops.plain_binop(op, F, a, b)))
                # one operand a single element, broadcast by the kernel
                worst = max(worst, _max_err(
                    cuda_ops.binop(op, F, a, b[:, 0]),
                    cuda_ops.plain_binop(
                        op, F, a, b[:, :1].expand(N_LIMBS, n).contiguous())))
                # every other element of each operand, read in place
                h = n // 2
                worst = max(worst, _max_err(
                    cuda_ops.binop(op, F, a[:, :2 * h:2], b[:, 1::2]),
                    cuda_ops.plain_binop(op, F, a[:, :2 * h:2].contiguous(),
                                         b[:, 1::2].contiguous())))
            # each column batch (16, C, N) the paths give it: against a
            # batch of the same shape, one element, a row (16, 1, N) and a
            # column (16, C, 1) broadcast (SHPLONK's fold weights)
            for cols, n in sorted({(c, m) for x in shs for c in x["batches"]
                                   for m in (x["n"], x["ext_n"])}):
                a = _rand_field(F, (cols, n), gen)
                b = _rand_field(F, (cols, n), gen)
                for rhs, full in ((b, b), (b[:, 0, 0], b[:, :1, :1]),
                                  (b[:, :1], b[:, :1]),
                                  (b[:, :, :1], b[:, :, :1])):
                    worst = max(worst, _max_err(
                        cuda_ops.binop(op, F, a, rhs),
                        cuda_ops.plain_op(op, F, a, full)))
            n = sh["ext_n"]
            a, b = _rand_field(F, (n,), gen), _rand_field(F, (n,), gen)
            t = _times(lambda: cuda_ops.binop(op, F, a, b),
                       _time_cuda(lambda: cuda_ops.plain_binop(op, F, a, b),
                                  2))
            muls, adds = (1, 0) if op == "mul" else (0, 1)
            variants.append({"variant": f"{op}/{F.name}", "n": n,
                             "max_abs_err": worst, **t,
                             **_bounds(3 * N_LIMBS * WORD * n, muls * n,
                                       adds * n)})
    variants.sort(key=lambda v: v["variant"] != "mul/Fr")
    # mul/Fr at the extended domain of each further path
    F = fr(device)
    for x in _other_paths(shs, "ext_n"):
        n = x["ext_n"]
        a, b = _rand_field(F, (n,), gen), _rand_field(F, (n,), gen)
        variants.append({
            "variant": f"mul/Fr {x['path']}", "n": n,
            "max_abs_err": _max_err(cuda_ops.binop("mul", F, a, b),
                                    cuda_ops.plain_binop("mul", F, a, b)),
            **_times(lambda: cuda_ops.binop("mul", F, a, b), _time_cuda(
                lambda: cuda_ops.plain_binop("mul", F, a, b), 2)),
            **_bounds(3 * N_LIMBS * WORD * n, n)})
    return _entry("field_binop", "halo2_tpu_torch/csrc/field_kernels.cu",
                  "halo2_tpu/fields/pallas_ops.py:65", variants,
                  f"mul/Fr (16, {sh['ext_n']})")


def _butterfly_case(sh, cols):
    """(mid, half, rep) of the widest stage of a path's coset extension:
    cols columns, the first radix-2 stage of the four-step's rows."""
    return cols, sh["ext_n"] // 2, 1 << ((sh["ext_k"] + 1) // 2)


def _stream_chunks(ext_k: int, chunks_log: int = STREAM_CHUNKS_LOG):
    """The first stage of each phase of NTT.inverse_streamed_nodiv at
    2^ext_k, as K2 sees it — (mid, half, rep) of a lane chunk's
    butterflies — and its mid-twiddle product as K3 sees it, (mid, k)."""
    n1 = 1 << ((ext_k + 1) // 2)
    n2 = (1 << ext_k) // n1
    w1, w2 = max(n1 >> chunks_log, 1), max(n2 >> chunks_log, 1)
    return {"phase 1": (1, (n2 // 2) * w1, w1),
            "phase 2": (1, (n1 // 2) * w2, w2), "mid": (1, n2 * w1)}


def _k2_butterfly(shs, gen, device, large_ext_k) -> dict:
    F = fr(device)
    worst = 0
    head = _butterfly_case(shs[0], 3)
    others = [(x["path"], _butterfly_case(x, x["horner_lanes"]))
              for x in _other_paths(shs, "ext_n")]
    chunks = _stream_chunks(large_ext_k)
    others += [(f"large chunk {ph}", chunks[ph])
               for ph in ("phase 1", "phase 2")]
    cases = [head] + [c for _, c in others] + [(5, 24, 4), (7, 1, 1),
                                               (1, 1000, 8)]
    for mid, half, rep in cases:
        x = _rand_field(F, (mid, 2, half), gen)
        tw = _rand_field(F, (half // rep,), gen)
        lo, hi = x[:, :, 0, :], x[:, :, 1, :]
        worst = max(worst, _max_err(cuda_ops.butterfly(F, lo, hi, tw, rep),
                                    cuda_ops.plain_butterfly(F, lo, hi, tw,
                                                             rep)))
    variants = []
    for name, (mid, half, rep) in [("Fr", head)] + [
            (f"Fr {path}", c) for path, c in others]:
        x = _rand_field(F, (mid, 2, half), gen)
        tw = _rand_field(F, (half // rep,), gen)
        lo, hi = x[:, :, 0, :], x[:, :, 1, :]
        n = mid * half
        t = _times(lambda: cuda_ops.butterfly(F, lo, hi, tw, rep), _time_cuda(
            lambda: cuda_ops.plain_butterfly(F, lo, hi, tw, rep), 2))
        variants.append({
            "variant": name, "shape": f"lo, hi (16, {mid}, {half}), "
                                      f"tw (16, {half // rep})",
            "max_abs_err": worst, **t,
            **_bounds((4 * n + half // rep) * N_LIMBS * WORD, n, 2 * n)})
    return _entry("ntt_butterfly", "halo2_tpu_torch/csrc/field_kernels.cu",
                  "halo2_tpu/fields/pallas_ops.py:115", variants,
                  variants[0]["shape"])


def _k3_mul_tiled(shs, gen, device, large_ext_k) -> dict:
    F = fr(device)
    worst = 0
    head = (3, shs[0]["ext_n"])
    others = [(x["path"], (x["horner_lanes"], x["ext_n"]))
              for x in _other_paths(shs, "ext_n")]
    others.append(("large chunk mid twiddle",
                   _stream_chunks(large_ext_k)["mid"]))
    cases = [head] + [c for _, c in others] + [
        (x["ext_n"] // 4, 4) for x in shs] + [(7, 1000), (1, 1)]
    for mid, kk in cases:
        a = _rand_field(F, (mid, kk), gen)
        t = _rand_field(F, (kk,), gen)
        worst = max(worst, _max_err(cuda_ops.mul_tiled(F, a, t),
                                    cuda_ops.plain_mul_tiled(F, a, t)))
    variants = []
    for name, (mid, kk) in [("Fr", head)] + [(f"Fr {path}", c)
                                             for path, c in others]:
        a, t = _rand_field(F, (mid, kk), gen), _rand_field(F, (kk,), gen)
        n = mid * kk
        tm = _times(lambda: cuda_ops.mul_tiled(F, a, t),
                    _time_cuda(lambda: cuda_ops.plain_mul_tiled(F, a, t), 2))
        variants.append({
            "variant": name, "shape": f"a (16, {mid}, {kk}), t (16, {kk})",
            "max_abs_err": worst, **tm,
            **_bounds((2 * n + kk) * N_LIMBS * WORD, n)})
    return _entry("mul_tiled", "halo2_tpu_torch/csrc/field_kernels.cu",
                  "halo2_tpu/fields/pallas_ops.py:149", variants,
                  variants[0]["shape"])


def _pow_products(e: int) -> tuple:
    """Squarings and multiplies of the pow kernel's schedule for the
    exponent e (the odd powers and the sliding windows,
    cuda_ops.pow_schedule)."""
    plan = cuda_ops.pow_schedule(e)
    return plan["squarings"], plan["multiplies"]


def _square_multiply_products(e: int) -> int:
    """Products of square and multiply for e (the pow kernel before its
    schedule, and the plain version)."""
    return 0 if e == 0 else e.bit_length() - 1 + bin(e).count("1") - 1


# columns a plain version takes at once at the large sizes (its int64
# partial products take some 4-7 GB a chunk)
PLAIN_CHUNK = 1 << 18


def _plain_by_chunks(fn, x, chunk=PLAIN_CHUNK):
    """fn over column chunks of x (16, n), joined: the plain version of an
    elementwise chain at a width it could not hold at once; fn returns a
    tensor or a tuple of them."""
    outs = [fn(x[:, j:j + chunk]) for j in range(0, x.shape[1], chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(c, dim=1) for c in zip(*outs))
    return torch.cat(outs, dim=1)


def _field_pow(sh, gen, device, ptxas) -> dict:
    """pow_static: one launch, against the composed plain loop; timed at
    the square roots of a params file's points (Fq, (q + 1) / 4, 2^k of
    them: `points_from_bytes` at load), at the k of the proof paths and at
    the large path's k = 22."""
    Fq = fq(device)
    e_sqrt = (Fq.p + 1) // 4
    sqr, mul = _pow_products(e_sqrt)
    variants = []
    for n in (sh["n"], 1 << LARGE_K):
        a = _rand_field(Fq, (n,), gen)
        want, plain_ms = profiling.timed(lambda: _plain_by_chunks(
            lambda c: Fq.plain_pow_static(c, e_sqrt), a, 4 * PLAIN_CHUNK))
        _expect_launches("pow_static", lambda: Fq.pow_static(a, e_sqrt),
                         {"pow": 1})
        variants.append({
            "variant": f"sqrt/Fq n={n}", "n": n,
            "max_abs_err": _max_err(Fq.pow_static(a, e_sqrt), want),
            **_times(lambda: Fq.pow_static(a, e_sqrt), plain_ms,
                     reps=20 if n <= sh["n"] else 5),
            **_bounds(2 * N_LIMBS * WORD * n, (sqr + mul) * n,
                      sqrs=sqr * n),
            "window": cuda_ops.pow_schedule(e_sqrt)["window"],
            "kernel_products": {
                "schedule": sqr + mul, "squarings": sqr, "multiplies": mul,
                "square_and_multiply":
                    _square_multiply_products(e_sqrt)}})
        del a, want
    # edge cases: 0, 1, p - 1 among the inputs; exponents 0, 1, 2, 3, 5,
    # (p + 1) / 4, p - 2, 2^255 + 1 (the longest run of squarings) and
    # 2^256 - 1 (every window full), one element, a batch of two dims
    worst = 0
    for F in (fr(device), fq(device)):
        a = _rand_field(F, (1000,), gen)
        for e in (0, 1, 2, 3, 5, (F.p + 1) // 4, F.p - 2, (1 << 255) + 1,
                  (1 << 256) - 1):
            worst = max(worst, _max_err(F.pow_static(a, e),
                                        F.plain_pow_static(a, e)))
            worst = max(worst, _max_err(F.pow_static(a[:, 5], e),
                                        F.plain_pow_static(a[:, 5:6], e)
                                        [:, 0]))
            b = a[:, :24].reshape(N_LIMBS, 4, 6)
            worst = max(worst, _max_err(F.pow_static(b, e),
                                        F.plain_pow_static(b, e)))
    variants[0]["max_abs_err"] = max(variants[0]["max_abs_err"], worst)
    entry = _entry("field_pow", "halo2_tpu_torch/csrc/field_kernels.cu",
                   "halo2_tpu/fields/limbs.py:533 pow_static (lax.scan)",
                   variants, f"sqrt/Fq (16, {sh['n']})")
    entry["blocks_per_sm"] = cuda_ops.occupancy()
    entry.update(_ptxas_of(ptxas, "pow_kernelILi1E"))
    return entry


# multiply-adds of one inversion by the kernel: 25 batches of the two
# matrix updates (9 limbs; 6 products a limb for (d, e), 4 for (f, g), and
# 2 for the multiples of p), then one Montgomery product.  The divsteps'
# shifts and logic run beside them on the integer ALUs and are not
# counted, so the bound is low.
INV_MADS = (cuda_ops.INV_BATCHES * (cuda_ops.INV_LIMBS * (6 + 4) + 2)
            + MADS_MUL)


def _field_inv(sh, gen, device) -> dict:
    """inv: one launch of the safegcd kernel, against Fermat's plain
    power; beside it the Fermat power's kernel (pow_static(p - 2), the
    kernel inv took over from) at the same inputs."""
    variants = []
    # the proof's shape (one element: batch_inverse's total) and 2^k
    for F, n in ((fr(device), 1), (fr(device), sh["n"]), (fq(device), 1)):
        a = _rand_field(F, (n,), gen, specials=False)
        a[0] |= 1                                # never zero
        want, plain_ms = profiling.timed(
            lambda: F.plain_pow_static(a, F.p - 2))
        _expect_launches(f"{F.name}.inv", lambda: F.inv(a), {"inv": 1})
        fermat = _times(lambda: F.pow_static(a, F.p - 2), plain_ms)
        variants.append({
            "variant": f"inv/{F.name} n={n}", "n": n,
            "max_abs_err": max(_max_err(F.inv(a), want),
                               _max_err(F.pow_static(a, F.p - 2), want)),
            **_times(lambda: F.inv(a), plain_ms),
            "fermat_pow_ms": fermat["ms"],
            "fermat_pow_device_ms": fermat["device_ms"],
            **dict(zip(("bound_ms", "bound_by"),
                       _bound(2 * N_LIMBS * WORD * n, INV_MADS * n)))})
    # edge cases: 0, 1, p - 1, R mod p and R^-1 mod p among the inputs,
    # one element, one column view, a batch of two dims
    worst = 0
    for F in (fr(device), fq(device)):
        a = _rand_field(F, (1000,), gen)
        a[:, 3] = F.encode_scalar(F.R)
        a[:, 4] = F.encode_scalar(F.R_inv)
        worst = max(worst, _max_err(F.inv(a), F.plain_pow_static(a, F.p - 2)))
        if F.decode(F.inv(a[:, :1])) != [0]:
            raise AssertionError(f"{F.name}.inv(0) is not 0")
        worst = max(worst, _max_err(F.inv(a[:, 5]),
                                    F.plain_pow_static(a[:, 5:6], F.p - 2)
                                    [:, 0]))
        b = a[:, :24].reshape(N_LIMBS, 4, 6)
        worst = max(worst, _max_err(F.inv(b),
                                    F.plain_pow_static(b, F.p - 2)))
        wide = _rand_field(F, (2 * 501,), gen)
        col = wide.reshape(N_LIMBS, 501, 2)[:, :, 1]        # a strided view
        worst = max(worst, _max_err(F.inv(col), F.plain_pow_static(
            col.contiguous(), F.p - 2)))
    variants[0]["max_abs_err"] = max(variants[0]["max_abs_err"], worst)
    return _entry("field_inv", "halo2_tpu_torch/csrc/field_kernels.cu",
                  "halo2_tpu/fields/limbs.py:533 pow_static(p - 2) (inv)",
                  variants, "inv/Fr (16, 1)")


def _scan_products(n: int) -> int:
    """Products the scan kernel makes on n elements (cuda_ops.scan_plan),
    printed as `kernel_products` beside the bound, which counts the n - 1
    products the prefix product needs; the look-back's windows aside
    (they depend on the blocks' timing):
    a tile's runs (V - 1 a thread), its warps' shuffle scans (31 + 30 +
    28 + 24 + 16 a warp), warp 0's scan of the warps' totals (31 + 30 +
    28), a prefix within the tile and the fold (1 + V a thread), and past
    the first tile a product a thread for the earlier tiles and one for
    the tile's inclusive prefix."""
    V, tiles = cuda_ops.scan_plan(n)
    block, warps = cuda_ops.SCAN_BLOCK, cuda_ops.SCAN_BLOCK // 32
    per_tile = (block * (V - 1) + warps * (31 + 30 + 28 + 24 + 16)
                + (31 + 30 + 28) + block * (1 + V))
    return tiles * per_tile + (tiles - 1) * (block + 1)


def _field_scan(shs, gen, device) -> dict:
    """prefix_mul: one launch, against the composed blocked scan."""
    sh = shs[0]
    variants = []
    F = fr(device)
    lengths = [sh["n"], 4 * sh["n"]]
    for x in shs:
        lengths += [m for m in x["prefix_lengths"] if m not in lengths]
    large = _shapes(LARGE_K, "large", MulChainCircuit(1))["prefix_lengths"]
    lengths += [m for m in large if m not in lengths]
    for n in lengths:
        a = _rand_field(F, (n,), gen)
        for reverse in (False, True):
            want, plain_ms = profiling.timed(
                lambda: F.plain_prefix_mul(a, reverse))
            _expect_launches("prefix_mul", lambda: F.prefix_mul(a, reverse),
                             {"scan": 1})
            variants.append({
                "variant": f"{'reverse' if reverse else 'forward'} n={n}",
                "n": n, "plan": cuda_ops.scan_plan(n),
                "max_abs_err": _max_err(F.prefix_mul(a, reverse), want),
                **_times(lambda: F.prefix_mul(a, reverse), plain_ms),
                **_bounds(2 * N_LIMBS * WORD * n, n - 1),
                "kernel_products": _scan_products(n)})
        del a, want
    # edge cases: n = 1, n at and around a tile, an n no multiple of a
    # tile, Fq, a strided view (every other element, a column), and each
    # run length the plan picks (V = 2, 4, 8 from 2^16, 2^17, 2^18 on)
    # with a last tile of one element and of all but one
    worst = 0
    for F in (fr(device), fq(device)):
        for n in (1, 2, 255, 256, 257, 1000, 2048, 4097, sh["n"] + 123,
                  (1 << 16) + 1, (1 << 16) + 511, (1 << 17) + 1,
                  (1 << 17) + 1023, (1 << 18) + 1, (1 << 18) + 2047):
            a = _rand_field(F, (n,), gen)
            for reverse in (False, True):
                worst = max(worst, _max_err(F.prefix_mul(a, reverse),
                                            F.plain_prefix_mul(a, reverse)))
        a = _rand_field(F, (2 * 5001,), gen)
        for view in (a[:, ::2], a[:, 7:8]):
            for reverse in (False, True):
                worst = max(worst, _max_err(
                    F.prefix_mul(view, reverse),
                    F.plain_prefix_mul(view.contiguous(), reverse)))
    variants[0]["max_abs_err"] = max(variants[0]["max_abs_err"], worst)
    return _entry("field_scan", "halo2_tpu_torch/csrc/field_kernels.cu",
                  "halo2_tpu/fields/limbs.py:559 prefix_mul (two lax.scans)",
                  variants, f"Fr (16, {sh['n']}), forward")


def _k4_point_op(sh, gen, device, pts) -> dict:
    n = sh["n"]
    aff_p, proj_p, aff_q, proj_q, ident = pts
    occupancy = cuda_point.occupancy()
    variants = []
    for op in ("add", "add_mixed", "double"):
        def args_for(p, q_proj, q_aff, sl):
            p = [c[:, sl].contiguous() for c in p]
            if op == "add":
                return p + [c[:, sl].contiguous() for c in q_proj]
            if op == "add_mixed":
                return p + [c[:, sl].contiguous() for c in q_aff]
            return p
        worst = 0
        checks = [
            (proj_p, proj_q, aff_q, slice(0, n)),        # main-path width
            (proj_p, proj_q, aff_q, slice(0, 1000)),     # ragged
            (proj_p, proj_q, aff_q, slice(5, 6)),        # one point
            (proj_p, proj_p, aff_p, slice(0, 1000)),     # P + P
            (ident, proj_q, aff_q, slice(0, 1000)),      # identity + Q
            (proj_p, ident, aff_q, slice(0, 1000)),      # P + identity
            (proj_p, g1.neg(proj_p), g1.neg(aff_p), slice(0, 1000)),  # P - P
        ]
        for p, qp, qa, sl in checks:
            coords = args_for(p, qp, qa, sl)
            worst = max(worst, _max_err(cuda_point.point_op(op, coords),
                                        cuda_point.plain_point_op(op, coords)))
        coords = args_for(proj_p, proj_q, aff_q, slice(0, n))
        muls, adds = POINT_OPS[op]
        variants.append({
            "variant": op, "n": n, "max_abs_err": worst,
            "blocks_per_sm": occupancy[op],
            **_times(lambda: cuda_point.point_op(op, coords), _time_cuda(
                lambda: cuda_point.plain_point_op(op, coords), 2)),
            **_bounds((len(coords) + 3) * N_LIMBS * WORD * n, muls * n,
                      adds * n, POINT_SQRS[op] * n)})
    e = _entry("point_op", "halo2_tpu_torch/csrc/point_kernels.cu",
               "halo2_tpu/curves/pallas_point.py:38", variants,
               f"add, 6 x (16, {n})")
    e["blocks_per_sm"] = occupancy
    return e


def _k5_packed(sh, gen, device, pts) -> dict:
    n = sh["n"]
    aff_p, proj_p, aff_q, proj_q, ident = pts
    worst = 0
    scan = min(sh["scan"], n)
    for m, carry in ((scan, proj_p), (1000, proj_p), (1, proj_p),
                     (1000, ident)):
        m = min(m, n)
        c = [x[:, :m].contiguous() for x in carry]
        packed = msm_sorted.pack_xy(aff_q[0][:, :m], aff_q[1][:, :m])
        sign = torch.randint(0, 2, (m,), dtype=torch.int32, device=device,
                             generator=gen)
        worst = max(worst, _max_err(
            cuda_point.add_mixed_packed(c, packed, sign),
            cuda_point.plain_add_mixed_packed(c, packed, sign)))
    if not bool((msm_sorted.pack_xy(aff_q[0], aff_q[1]) < 0).any()):
        raise AssertionError("no packed word with its top bit set was tried")
    # time at the scan's own width: every window's block side by side
    reps = -(-sh["scan"] // n)
    wide = lambda x: x.repeat(1, reps)[:, :sh["scan"]].contiguous()  # noqa
    c = [wide(x) for x in proj_p]
    packed = wide(msm_sorted.pack_xy(aff_q[0], aff_q[1]))
    sign = torch.randint(0, 2, (sh["scan"],), dtype=torch.int32,
                         device=device, generator=gen)
    worst = max(worst, _max_err(
        cuda_point.add_mixed_packed(c, packed, sign),
        cuda_point.plain_add_mixed_packed(c, packed, sign)))
    muls, adds = POINT_OPS["add_mixed"]
    m = sh["scan"]
    v = {"variant": "add_mixed_packed", "max_abs_err": worst,
         **_times(lambda: cuda_point.add_mixed_packed(c, packed, sign),
                  _time_cuda(lambda: cuda_point.plain_add_mixed_packed(
                      c, packed, sign), 2)),
         **_bounds((7 * N_LIMBS + 1) * WORD * m, muls * m, (adds + 1) * m)}
    e = _entry("add_mixed_packed", "halo2_tpu_torch/csrc/point_kernels.cu",
               "halo2_tpu/curves/pallas_point.py:73", [v],
               f"carry 3 x (16, {m}), packed (16, {m}), sign ({m},)")
    e["launches_from"] = ("the prove, args and multi paths launch it 0 "
                          "times: "
                          "msm_scan runs every step of a window group in "
                          "one launch")
    return e


def _ptxas_of(ptxas: dict, kernel: str) -> dict:
    """Registers and stack bytes of a kernel, by its name in the ptxas
    log of this run's build."""
    for name, usage in ptxas.items():
        if kernel in name and "registers" in usage:
            return {"registers": usage["registers"],
                    "stack_bytes": usage.get("stack_bytes", 0)}
    return {"registers": None, "stack_bytes": None}


def _scan_inputs(gen, device, G, n, c, kind):
    """Sorted (order, key) of G windows of n points: the signed c-bit
    digits of random 254-bit scalars, or an edge case of the digits and
    signs."""
    nb = (1 << (c - 1)) + 1
    if kind == "scalars":
        mag, neg = msm_sorted._signed_digits(_rand_scalars(n, gen, device),
                                             G, c)
    else:
        rand = lambda hi: torch.randint(  # noqa: E731
            0, hi, (G, n), dtype=torch.int32, device=device, generator=gen)
        neg = rand(2)
        if kind == "one bucket":
            mag = torch.full((G, n), 7, dtype=torch.int32, device=device)
        elif kind == "digit 0 and the top":
            mag = rand(2) * (nb - 1)
        elif kind == "all signs set":
            mag, neg = rand(nb), torch.ones_like(neg)
        elif kind == "empty buckets between":
            mag = torch.tensor([3, 100, nb - 1], dtype=torch.int32,
                               device=device)[rand(3).long()]
        elif kind == "digits at and above nb":
            # what a max_bits below the scalars' would give: such digits
            # fall in no bucket, in every window and in the last
            mag = rand(nb + 4)
            mag[:, 0], mag[:, -1] = nb, nb + 3
        else:
            mag = rand(nb)
    key, order = torch.sort((mag << 1) | neg, dim=1, stable=True)
    return order, key


def _msm_scan(sh, gen, device, pts, ptxas) -> dict:
    """The MSM's bucket scan of one window group: one launch, against the
    loop of plain scan steps."""
    aff_q = pts[2]
    n, G, B, nb = sh["n"], sh["windows"], sh["block"], sh["nb"]
    rows = msm_sorted.pack_xy(aff_q[0], aff_q[1]).t().contiguous()
    order, key = _scan_inputs(gen, device, G, n, sh["c"], "scalars")

    def run():
        return cuda_point.msm_scan(rows, order, key, B, nb)
    want, plain_ms = profiling.timed(
        lambda: cuda_point.plain_msm_scan(rows, order, key, B, nb))
    _expect_launches("msm_scan", run, {"msm_scan": 1})
    worst = _max_err(_flat_scan(run()), _flat_scan(want))
    n_neg = int((key & 1).sum().item())
    muls, adds = POINT_OPS["add_mixed"]
    v = {"variant": f"G={G} S={n // B} B={B}", "max_abs_err": worst,
         **_times(run, plain_ms),
         **_bounds(rows.numel() * WORD + 12 * G * n
                   + 3 * N_LIMBS * WORD * G * (B + nb) + WORD * G * nb,
                   muls * G * n, adds * G * n + n_neg)}
    # edge cases, at the proof's block with fewer windows and steps
    edges = []
    for kind, G_, S_ in (("one bucket", 3, 4), ("digit 0 and the top", 3, 4),
                         ("all signs set", 3, 4), ("digits", 1, 4),
                         ("digits", 3, 1), ("empty buckets between", 3, 4),
                         ("digits at and above nb", 3, 4)):
        o, k = _scan_inputs(gen, device, G_, S_ * B, sh["c"], kind)
        err = _max_err(
            _flat_scan(cuda_point.msm_scan(rows, o, k, B, nb)),
            _flat_scan(cuda_point.plain_msm_scan(rows, o, k, B, nb)))
        edges.append({"case": kind, "G": G_, "S": S_, "max_abs_err": err})
    v["max_abs_err"] = max([worst] + [e["max_abs_err"] for e in edges])
    v["edge_cases"] = edges
    e = _entry("msm_scan", "halo2_tpu_torch/csrc/point_kernels.cu",
               "halo2_tpu/curves/pallas_point.py:73 (every step of "
               "halo2_tpu/msm/sorted.py:144 _prefix_scan_group)", [v],
               f"rows ({n}, 16), order and key ({G}, {n}), block {B}, "
               f"nb {nb}")
    e.update(_ptxas_of(ptxas, "msm_scan_kernel"))
    return e


def _flat_scan(out):
    """msm_scan's (totals, table, blk) as one list of tensors."""
    totals, table, blk = out
    return list(totals) + list(table) + [blk]


def _horner_bounds(lanes, W, c, tail) -> dict:
    dm_, da = POINT_OPS["double"]
    am, aa = POINT_OPS["add"]
    chain = (W - 1) * c + tail
    return _bounds(3 * N_LIMBS * WORD * lanes * (W + 1),
                   lanes * (chain * dm_ + (W - 1) * am),
                   lanes * (chain * da + (W - 1) * aa),
                   lanes * chain * POINT_SQRS["double"])


def _point_horner(shs, gen, device, pts, ptxas) -> dict:
    """The Horner combine: one launch, against the composed loop."""
    sh = shs[0]
    aff_p, proj_p, aff_q, proj_q, ident = pts
    lanes, W, c = sh["horner_lanes"], sh["windows"], sh["c"]
    pick = lambda m: tuple(x[:, :m] for x in proj_p)  # noqa: E731

    def totals_of(lanes_, W_):
        t = tuple(x.reshape(N_LIMBS, lanes_, W_).contiguous()
                  for x in pick(lanes_ * W_))
        return t
    variants = []
    # the proof's widest combine, and the Abel sum's M * E_M doublings
    # (W = 1, c = 0, log2(2^(c-1)) = c - 1 doublings on every window)
    # and the widest combine of each further path
    for name, tot, cb, tail in [
            (f"combine lanes={lanes} W={W} c={c}", totals_of(lanes, W), c, 0),
            (f"abel lanes={sh['windows']} doublings={c - 1}",
             totals_of(sh["windows"], 1), 0, c - 1)] + [
            (f"combine lanes={x['horner_lanes']} W={x['windows']} "
             f"c={x['c']} {x['path']}",
             totals_of(x["horner_lanes"], x["windows"]), x["c"], 0)
            for x in _other_paths(shs, "horner_lanes")]:
        want, plain_ms = profiling.timed(
            lambda: g1.plain_horner(tot, cb, tail))
        got = g1.horner(tot, cb, tail)
        L_, W_ = cuda_point.horner_shape(tot[0].shape)
        variants.append({
            "variant": name, "max_abs_err": _max_err(got, want),
            **_times(lambda: cuda_point.horner(tot, cb, tail), plain_ms),
            **_horner_bounds(L_, W_, cb, tail)})
    _expect_launches("_combine_windows",
                     lambda: msm._combine_windows(totals_of(lanes, W), c),
                     {"horner": 1})
    # edge cases: identity lanes and windows (an all-identity lane, zero
    # windows at the top, the middle and the bottom), W = 1, one lane,
    # lane counts that are no multiple of the lanes a block (17, 5), lanes
    # of two dims, the window axis strided
    worst = 0
    tot = [x.clone() for x in totals_of(4, W)]
    for lane, ws in ((0, range(W)), (1, (W - 1,)), (2, (W // 2,)), (3, (0,))):
        for w in ws:
            for x, v in zip(tot, ident):
                x[:, lane, w] = v[:, 0]
    cases = [(tuple(tot), c, 0), (tuple(tot), 3, 2), (totals_of(1, 1), 5, 0),
             (totals_of(1, 2), 4, 0), (totals_of(1, W), c, 0),
             (totals_of(17, 3), 4, 1), (totals_of(5, 4), 3, 0),
             (tuple(x.reshape(N_LIMBS, 2, 2, 3) for x in totals_of(4, 3)),
              4, 1),
             (tuple(x[:, :, ::2] for x in totals_of(2, 6)), 2, 0)]
    for t, cb, tail in cases:
        worst = max(worst, _max_err(cuda_point.horner(t, cb, tail),
                                    g1.plain_horner(t, cb, tail)))
    variants[0]["max_abs_err"] = max(variants[0]["max_abs_err"], worst)
    e = _entry("point_horner", "halo2_tpu_torch/csrc/point_kernels.cu",
               "halo2_tpu/msm/msm.py:152 _combine_windows (lax.scan)",
               variants, f"3 x (16, {lanes}, {W}), c = {c}")
    e.update(_ptxas_of(ptxas, "point_horner_kernel"))
    return e


def _rand_scalars(n, gen, device):
    """(16, n) standard-form limbs of random 254-bit scalars."""
    s = torch.randint(0, 1 << 16, (N_LIMBS, n), dtype=torch.int32,
                      device=device, generator=gen)
    s[N_LIMBS - 1] &= 0x3FFF
    return s


def _point_ladder(sh, gen, device, pts) -> dict:
    """scalar_mul: one launch, against the composed ladder."""
    aff_p = pts[0]
    n = sh["n"]
    s = _rand_scalars(n, gen, device)
    want, plain_ms = profiling.timed(lambda: g1.plain_scalar_mul(aff_p, s))
    _expect_launches("scalar_mul", lambda: g1.scalar_mul(aff_p, s),
                     {"ladder": 1})
    bits = sum(bin(v).count("1") for v in limbs_to_ints(s.cpu().numpy()))
    dm_, da = POINT_OPS["double"]
    am, aa = POINT_OPS["add"]
    v = {"variant": f"n={n}", "n": n,
         "max_abs_err": _max_err(g1.scalar_mul(aff_p, s), want),
         **_times(lambda: g1.scalar_mul(aff_p, s), plain_ms, reps=5),
         **_bounds(6 * N_LIMBS * WORD * n, 255 * n * dm_ + bits * am,
                   255 * n * da + bits * aa, 255 * n * POINT_SQRS["double"])}
    # edge cases: scalars 0, 1, all 256 bits set, one point, a ragged batch
    m = 1000
    s = _rand_scalars(m, gen, device)
    s[:, 0] = 0
    s[:, 1] = 0
    s[0, 1] = 1
    s[:, 2] = 0xFFFF
    p = tuple(c[:, :m] for c in aff_p)
    worst = max(_max_err(g1.scalar_mul(p, s), g1.plain_scalar_mul(p, s)),
                _max_err(g1.scalar_mul(tuple(c[:, 7:8] for c in p),
                                       s[:, 2:3]),
                         g1.plain_scalar_mul(tuple(c[:, 7:8] for c in p),
                                             s[:, 2:3])))
    if not bool(g1.is_identity(g1.scalar_mul(p, s))[0]):
        raise AssertionError("0 * P is not the identity")
    v["max_abs_err"] = max(v["max_abs_err"], worst)
    return _entry("point_ladder", "halo2_tpu_torch/csrc/point_kernels.cu",
                  "halo2_tpu/curves/g1.py:141 scalar_mul (lax.scan)", [v],
                  f"(x, y) 2 x (16, {n}), scalars (16, {n})")


def _nonzero_bytes(s) -> int:
    """The bytes of standard-form scalar limbs (16, n) that are not 0: the
    mixed adds the comb of 8-bit windows needs."""
    return int(((s & 0xFF) != 0).sum().item()
               + ((s >> 8) != 0).sum().item())


def _fixed_base(sh, gen, device, ptxas) -> dict:
    """fixed_base_mul: one launch, against the composed plain comb, at the
    scalars of unsafe_setup at the proof paths' k and at the large path's
    k = 22; its affine points equal the ladder's on the same scalars."""
    rows = g1.fixed_base_table(device).rows
    # the plain version's table: the same points as affine limbs
    xy = g1.fixed_base_table("cpu").xy.to(device)
    muls, adds = POINT_OPS["add_mixed"]
    gen_aff = g1.generator(device)
    variants = []
    for k in (sh["k"], LARGE_K):
        n = 1 << k
        s, _ = setup_scalars(k, int(torch.randint(
            1, 1 << 62, (1,), generator=gen, device=device).item()), device)
        want, plain_ms = profiling.timed(lambda: _plain_by_chunks(
            lambda c: g1.plain_fixed_base_mul(xy, c), s))
        _expect_launches("fixed_base_mul", lambda: g1.fixed_base_mul(s),
                         {"fixed_base": 1})
        got = g1.fixed_base_mul(s)
        base = tuple(c[:, None].expand(N_LIMBS, n) for c in gen_aff)
        ladder = g1.scalar_mul(base, s)
        if not torch.equal(torch.stack(g1.to_affine(got)),
                           torch.stack(g1.to_affine(ladder))):
            raise AssertionError(f"fixed_base_mul and the ladder differ in "
                                 f"affine at n = {n}")
        del ladder
        adds_needed = _nonzero_bytes(s)
        variants.append({
            "variant": f"setup scalars n={n}", "n": n,
            "max_abs_err": _max_err(got, want), "affine_equal_ladder": True,
            **_times(lambda: g1.fixed_base_mul(s), plain_ms,
                     reps=20 if n <= sh["n"] else 5),
            **_bounds(4 * N_LIMBS * WORD * n + rows.numel() * WORD,
                      muls * adds_needed, adds * adds_needed),
            "mixed_adds": adds_needed,
            "kernel_ops": {"mixed_adds": g1.FB_WINDOWS * n,
                           **_bounds(4 * N_LIMBS * WORD * n
                                     + rows.numel() * WORD,
                                     muls * g1.FB_WINDOWS * n,
                                     adds * g1.FB_WINDOWS * n)}})
        del s, want, got
    # edge scalars: 0, 1, 255, 256, r - 1, every byte 0xFF, only the top
    # window set, random; a ragged batch, one scalar, a batch of two dims,
    # a strided view
    R_ = fr(device).p
    edge = [0, 1, 255, 256, R_ - 1, (1 << 256) - 1, 0xFF << 248,
            1 << 248]
    s = _rand_scalars(1000, gen, device)
    s[:, :len(edge)] = torch.from_numpy(
        ints_to_limbs_np(edge).astype(np.int32)).to(device)
    worst = 0
    for x in (s, s[:, 5:6], s[:, 3:4], s[:, :24].reshape(N_LIMBS, 4, 6),
              s[:, ::3]):
        worst = max(worst, _max_err(
            g1.fixed_base_mul(x), g1.plain_fixed_base_mul(xy,
                                                          x.contiguous())))
    if not bool(g1.is_identity(g1.fixed_base_mul(s[:, :1]))[0]):
        raise AssertionError("fixed_base_mul(0) is not the identity")
    variants[0]["max_abs_err"] = max(variants[0]["max_abs_err"], worst)
    variants[0]["edge_scalars"] = len(edge)
    e = _entry("fixed_base", "halo2_tpu_torch/csrc/point_kernels.cu",
               "halo2_tpu/curves/g1.py:141 scalar_mul (lax.scan), as "
               "Params.unsafe_setup calls it (the generator)", variants,
               f"scalars (16, {sh['n']}), table (8192, 16)")
    e["blocks_per_sm"] = cuda_point.occupancy()["fixed_base"]
    e.update(_ptxas_of(ptxas, "fixed_base_kernel"))
    return e


# the bucket path's kernel: point counts (one, ragged, the golden proofs'
# 16, 32 and 512, the largest below SORT_BLOCK) and lane counts
BUCKET_NS = (1, 7, 16, 32, 512, 2047)
BUCKET_LANES = (1, 4, 64)
# the K of the golden proof whose commitments are the widest bucket batch
# (AllArgsCircuit, tests/data/torch_golden_args.json)
GOLDEN_ARGS_K = 9
# the bucket kernel's timed shapes: (label, n, columns or None for the
# golden AllArgs proof's widest commitment batch, scalars): that batch (n =
# 512, its columns' full windows in one launch), the K = 4 proof's single
# column, and the largest n below SORT_BLOCK, with 254-bit scalars (the top
# byte up to 0x3F) and with canonical ones (below r, the top byte up to
# 0x30, as a commitment's values are: the top window's buckets crowd)
BUCKET_TIMED = ((f"golden K = {GOLDEN_ARGS_K}", 512, None, 254),
                ("golden K = 4", 16, 1, 254),
                ("largest n", SORT_BLOCK - 1, 1, 254),
                ("largest n, canonical scalars", SORT_BLOCK - 1, 1,
                 "canonical"))
# the points of msm_many's bucket path held to its sorted path
BUCKET_MANY_N = 512


def _bucket_inputs(n, bits, lanes, gen, device, pts):
    """The bucket path's kernel inputs for n points and scalars below
    2^bits (or below r, uniform below its top limb, where bits is
    "canonical"): the points padded to a multiple of `lanes` with copies
    of the first under zero digits (as msm/msm.py pads them), and the
    8-bit digits of random standard-form scalars, 0, 1 and 255 among the
    first."""
    s = _rand_scalars(n, gen, device)
    if bits == "canonical":
        s[N_LIMBS - 1] = torch.randint(0, P >> 240, (n,), dtype=torch.int32,
                                       device=device, generator=gen)
        bits = 254
    s[-(-bits // 16):] = 0                   # the limbs at and above 2^bits
    if n >= 3:
        s[:, :3] = 0
        s[0, 1] = 1
        s[0, 2] = 0xFF
    pad = (-n) % lanes
    s = torch.nn.functional.pad(s, (0, pad))
    px, py = (torch.cat([c[:, :n], c[:, :1].expand(N_LIMBS, pad)], dim=1)
              for c in pts)
    return px, py, msm._digits(s, msm.bucket_windows(bits))


def _bucket_work(digits) -> tuple:
    """(mixed adds, complete adds) the function needs for these digits:
    a mixed add for every digit that is not 0, and for each row the
    running sum's reduction (an add for every non-empty bucket after the
    first, and one for every bucket below the top one)."""
    R = digits.shape[0]
    present = torch.zeros((R, cuda_point.BUCKETS), dtype=torch.int64,
                          device=digits.device)
    present.scatter_(1, digits.to(torch.int64), 1)
    nonempty = present[:, 1:].sum(dim=1)
    top = digits.max(dim=1).values.to(torch.int64)
    reduce = (nonempty - 1).clamp(min=0) + (top - 1).clamp(min=0)
    return int((digits != 0).sum().item()), int(reduce.sum().item())


def _bucket_bounds(n, digits) -> dict:
    """The function's bound (`_bucket_work`), with the kernel's own count
    of its operations beside it (`kernel_*`, cuda_point.msm_bucket_ops)."""
    mixed, full = _bucket_work(digits)
    am, aa = POINT_OPS["add_mixed"]
    cm, ca = POINT_OPS["add"]
    R = digits.shape[0]
    threads = cuda_point.bucket_threads(R, torch.cuda.get_device_properties(
        digits.device).multi_processor_count)
    own = cuda_point.msm_bucket_ops(digits, threads)
    return {"mixed_adds": mixed, "complete_adds": full, "threads": threads,
            "kernel_mixed_adds": own["mixed_adds"],
            "kernel_adds": own["complete_adds"],
            "kernel_doublings": own["doublings"],
            **_bounds(2 * N_LIMBS * WORD * n + WORD * R * n
                      + 3 * N_LIMBS * WORD * R,
                      am * mixed + cm * full, aa * mixed + ca * full)}


def _affine(p):
    return torch.stack(g1.to_affine(p))


def _msm_bucket(gen, device, ptxas) -> dict:
    """The bucket path's kernel: one launch, against the plain lane-private
    buckets, exactly after to_affine (the two add in other orders, so their
    projective limbs differ), at every n of BUCKET_NS with full and 16-bit
    scalars and every lane count of BUCKET_LANES, and at the largest n
    with canonical scalars; timed at the golden proofs' shapes and the
    largest n; and msm_many's bucket path against its sorted path."""
    n_max = max(BUCKET_NS + (BUCKET_MANY_N,))
    aff, _ = _rand_points(n_max, gen, device)
    cases = []
    worst = 0
    for n in BUCKET_NS:
        for bits in (254, 16):
            for lanes in BUCKET_LANES:
                px, py, d = _bucket_inputs(n, bits, lanes, gen, device, aff)
                got = _affine(cuda_point.msm_bucket(px, py, d, lanes))
                want = _affine(cuda_point.plain_msm_bucket(px, py, d, lanes))
                err = _max_err(got, want)
                worst = max(worst, err)
                cases.append({"n": n, "bits": bits, "lanes": lanes,
                              "rows": d.shape[0], "max_abs_err": err})
    # every scalar 0: the identity
    px, py, d = _bucket_inputs(16, 254, 1, gen, device, aff)
    if not bool(g1.is_identity(cuda_point.msm_bucket(
            px, py, torch.zeros_like(d), 1)).all()):
        raise AssertionError("msm_bucket of zero scalars is not the "
                             "identity")
    C = _shapes(GOLDEN_ARGS_K, "golden", AllArgsCircuit())["horner_lanes"]
    variants = []
    for label, n, cols, bits in BUCKET_TIMED:
        cols = cols or C
        lanes = msm._pick_lanes(n)
        parts = [_bucket_inputs(n, bits, lanes, gen, device, aff)
                 for _ in range(cols)]
        px, py = parts[0][0], parts[0][1]
        d = torch.cat([p[2] for p in parts])
        want, plain_ms = profiling.timed(
            lambda: cuda_point.plain_msm_bucket(px, py, d, lanes))

        def run():
            return cuda_point.msm_bucket(px, py, d, lanes)
        _expect_launches("msm_bucket", run, {"msm_bucket": 1})
        variants.append({
            "variant": f"{label}: n={n} lanes={lanes} rows={d.shape[0]}",
            "max_abs_err": _max_err(_affine(run()), _affine(want)),
            **_times(run, plain_ms), **_bucket_bounds(px.shape[1], d)})
        del want
    # the largest n with canonical scalars (drawn last, so that the shapes
    # above keep their inputs from the seed)
    for lanes in BUCKET_LANES:
        px, py, d = _bucket_inputs(n_max, "canonical", lanes, gen, device,
                                   aff)
        got = _affine(cuda_point.msm_bucket(px, py, d, lanes))
        want = _affine(cuda_point.plain_msm_bucket(px, py, d, lanes))
        err = _max_err(got, want)
        worst = max(worst, err)
        cases.append({"n": n_max, "bits": "canonical", "lanes": lanes,
                      "rows": d.shape[0], "max_abs_err": err})
    variants[0]["max_abs_err"] = max(variants[0]["max_abs_err"], worst)
    variants[0]["cases"] = cases
    # msm_many's bucket path (one launch for both columns, a short one
    # padded with identity windows) against its sorted path
    n = BUCKET_MANY_N
    pts = tuple(c[:, :n] for c in aff)
    F = fr(device)
    std = [_rand_scalars(n, gen, device) for _ in range(2)]
    std[1][1:] = 0                           # below 2^16
    cols = [F.to_mont(x) for x in std]
    bits = [256, 16]
    got = _launches_of(lambda: msm_many(pts, cols, bits))
    if got.get("msm_bucket") != 1 or got.get("msm_scan") \
            or got.get("horner") != 1:
        raise AssertionError(f"msm_many of {n} points launched {got}, "
                             f"expected one msm_bucket, one horner and no "
                             f"msm_scan")
    block = msm._block_for(n)
    sorted_ = msm._combine_windows(
        msm.column_totals(pts[0], pts[1], cols, bits, block),
        window_bits_for(block))
    if not torch.equal(_affine(msm_many(pts, cols, bits)), _affine(sorted_)):
        raise AssertionError("msm_many's bucket path and sorted path differ")
    variants[0]["msm_many_equals_sorted"] = True
    e = _entry("msm_bucket", "halo2_tpu_torch/csrc/point_kernels.cu",
               "halo2_tpu/msm/msm.py:54 _accumulate (lax.scan) + :113 "
               "_merge_lanes + :118 _reduce_buckets", variants,
               f"x, y (16, n), digits (rows, n), n < {SORT_BLOCK}")
    occ = cuda_point.occupancy()
    e["blocks_per_sm"] = occ["msm_bucket"]
    e["blocks_per_sm_128"] = occ["msm_bucket_128"]
    e.update(_ptxas_of(ptxas, "msm_bucket_kernel"))
    return e


# the decode's (C, n): C n = 1, 7, 2^16 + 3, then the main path's, which
# are timed: a k = 20 witness file (3 columns), the k = 20 blind (2^21
# rows) and a k = 22 witness file; a row >= p is planted in the
# unmasked k = 20 file
DECODE_SHAPES = ((1, 1), (1, 7), (1, (1 << 16) + 3), (3, 1 << 20),
                 (1, 1 << 21), (3, 1 << 22))
DECODE_TIMED = 3
DECODE_PLANT = (3, 1 << 20)
# bytes a value: the row read, the limbs written
DECODE_BYTES = 32 + N_LIMBS * WORD


def _decode_rows(C, n, gen, device, mask):
    """(C, n, 8) int32 words of random rows on the card: below 2^252 < p,
    or any 256 bits where the decode masks them, with 0, 1, p - 1 and
    2^253 - 1 as each column's first rows."""
    words = torch.randint(0, 1 << 32, (C, n, 8), dtype=torch.int64,
                          device=device, generator=gen).to(torch.int32)
    if not mask:
        words[..., 7] &= 0x0FFFFFFF
    for i, x in enumerate([0, 1, P - 1, (1 << 253) - 1][:n]):
        words[:, i] = torch.from_numpy(np.frombuffer(
            x.to_bytes(32, "little"), dtype=np.int32).copy()).to(device)
    return words


def _u64_stats(stats) -> list:
    return [[int(v) for v in row] for row in
            stats.cpu().numpy().view(np.uint64)]


def _plain_decode(F, rows, mask):
    """The plain version over row chunks of each column: (limbs, stats as
    ints), the chunks' stats joined by their maxima."""
    C, n = rows.shape[:2]
    limbs = torch.empty((N_LIMBS, C, n), dtype=torch.int32,
                        device=rows.device)
    stats = [[0] * cuda_ops.DECODE_STATS for _ in range(C)]
    for c in range(C):
        for j in range(0, n, PLAIN_CHUNK):
            out, st = cuda_ops.plain_decode_le32(
                F, rows[c:c + 1, j:j + PLAIN_CHUNK], mask)
            limbs[:, c:c + 1, j:j + PLAIN_CHUNK] = out
            stats[c] = [max(a, b) for a, b in zip(stats[c],
                                                  _u64_stats(st)[0])]
    return limbs, stats


def _decode_le32(gen, device, ptxas) -> dict:
    """decode_le32: one launch, against its plain version exactly (limbs
    and each column's stats), masked and unmasked at every shape of
    DECODE_SHAPES, a row >= p planted in one run; timed at the main
    path's shapes beside the bound by bytes, with the pinned upload of the
    same rows; and the staged path (`encode_le_bytes_dev`, twice without a
    wait: the staging buffer is reused) against the plain version."""
    F = fr(device)
    variants, worst = [], 0
    for idx, (C, n) in enumerate(DECODE_SHAPES):
        for mask in (False, True):
            rows = _decode_rows(C, n, gen, device, mask)
            planted = (C, n) == DECODE_PLANT and not mask
            if planted:
                rows[1, n // 2] = torch.from_numpy(np.frombuffer(
                    P.to_bytes(32, "little"), dtype=np.int32).copy())
            (want, want_stats), plain_ms = profiling.timed(
                lambda: _plain_decode(F, rows, mask))
            _expect_launches("decode_le32", lambda: cuda_ops.decode_le32(
                F, rows, mask), {"decode_le32": 1})
            got, stats = cuda_ops.decode_le32(F, rows, mask)
            err = _max_err(got, want)
            if _u64_stats(stats) != want_stats:
                raise AssertionError(f"decode_le32 {C} x {n} mask={mask}: "
                                     f"stats differ from the plain version")
            if planted and [s[4] for s in want_stats] != [0, 1, 0]:
                raise AssertionError("decode_le32: the planted row >= p "
                                     "is not flagged in its column alone")
            worst = max(worst, err)
            if idx < len(DECODE_SHAPES) - DECODE_TIMED:
                continue
            host = cuda_ops.staging(rows.numel() * WORD)
            host.copy_(rows.reshape(-1).view(torch.uint8).cpu())
            _, upload_ms = profiling.timed(
                lambda: cuda_ops.upload(host, device))
            variants.append({
                "variant": f"Fr C={C} n={n} mask={mask}", "C": C, "n": n,
                "max_abs_err": err, "planted_ge_p": planted,
                **_times(lambda: cuda_ops.decode_le32(F, rows, mask),
                         plain_ms, reps=20 if C * n <= 1 << 21 else 5),
                **_bounds(DECODE_BYTES * C * n, C * n),
                "upload_ms": upload_ms,
                "upload_GB_per_s": rows.numel() * WORD / upload_ms / 1e6})
            del rows, want, got
    # the staged path, twice before any wait, against the plain version
    blobs = [_decode_rows(1, (1 << 16) + 3, gen, device, False)
             for _ in range(2)]
    outs = [F.encode_le_bytes_dev(b.cpu().numpy(), b.shape[1])
            for b in blobs]
    for b, out in zip(blobs, outs):
        worst = max(worst, _max_err(
            out, cuda_ops.plain_decode_le32(F, b)[0][:, 0, :]))
    variants[0]["max_abs_err"] = max(variants[0]["max_abs_err"], worst)
    e = _entry("decode_le32", "halo2_tpu_torch/csrc/field_kernels.cu",
               "none: host numpy passes (io/serialization.py load_witness, "
               "plonk/vanishing.py _random_coeffs)", variants,
               "rows (C, n, 8) u32 -> (16, C, n), C n = 3 x 2^20")
    e.update(_ptxas_of(ptxas, "decode_le32_kernel"))
    return e


def phase_kernels(k: int, device, ptxas: dict) -> list:
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    shs = [_shapes(k, path, make(), proofs, shplonk)
           for path, make, proofs, shplonk in PATH_CIRCUITS]
    sh = shs[0]
    for x in shs[1:]:
        for key in ("n", "windows", "c", "block", "nb", "scan"):
            if x[key] != sh[key]:
                raise AssertionError(f"the {x['path']} path's {key} differs "
                                     f"from the {sh['path']} path's: check "
                                     f"it at its own shape")
    n = sh["n"]
    aff_p, proj_p = _rand_points(n, gen, device)
    aff_q, proj_q = _rand_points(n, gen, device)
    pts = (aff_p, proj_p, aff_q, proj_q, g1.identity((n,), device))
    large_ext_k = _shapes(LARGE_K, "large", MulChainCircuit(1))["ext_k"]
    entries = [_k1_binop(shs, gen, device),
               _k2_butterfly(shs, gen, device, large_ext_k),
               _k3_mul_tiled(shs, gen, device, large_ext_k),
               _field_pow(sh, gen, device, ptxas),
               _field_inv(sh, gen, device),
               _field_scan(shs, gen, device),
               _k4_point_op(sh, gen, device, pts),
               _k5_packed(sh, gen, device, pts),
               _msm_scan(sh, gen, device, pts, ptxas),
               _point_horner(shs, gen, device, pts, ptxas),
               _point_ladder(sh, gen, device, pts),
               _fixed_base(sh, gen, device, ptxas),
               _msm_bucket(gen, device, ptxas),
               _decode_le32(gen, device, ptxas)]
    for e in entries:
        if e["max_abs_err"] != 0:
            raise AssertionError(
                f"kernel {e['name']} disagrees with its plain version: "
                f"max abs err {e['max_abs_err']}")
    return entries


# the modules of the three sanity checks (HALO2_TPU_SANITY_CHECKS)
SANITY_MODULES = (permutation, logup_prover, shuffle_prover)
# lines of the span profiler's report printed by the golden phase
REPORT_LINES = 24


def phase_golden(device) -> dict:
    """The golden proofs with the sanity checks and the span profiler on
    (synchronising), the launch counts set to 0 just before and read just
    after: every MSM there is of fewer than SORT_BLOCK points, so the
    bucket kernel runs and the sorted path's scan does not.  Prints the
    report's first lines, then the phase's line; returns the launches."""
    saved = [m._SANITY for m in SANITY_MODULES]
    for m in SANITY_MODULES:
        m._SANITY = True
    profiling.reset()
    profiling.enable(True, sync=True)
    _reset_counts()                          # the golden path starts here
    try:
        out = _golden_proofs(device)
    finally:
        profiling.enable(False, sync=False)
        for m, was in zip(SANITY_MODULES, saved):
            m._SANITY = was
    launches = {**cuda_ops.launch_counts, **cuda_point.launch_counts}
    counters = dict(profiling.counters)      # and ends here
    report = profiling.report(file=io.StringIO()).splitlines()
    if launches["msm_bucket"] < 1 or launches["msm_scan"]:
        raise AssertionError(f"golden: msm_bucket made "
                             f"{launches['msm_bucket']} launches and "
                             f"msm_scan {launches['msm_scan']}, expected "
                             f"some and none")
    for kernel, per in LAUNCHES_PER_COUNTER:
        if launches[kernel] != counters.get(per, 0):
            raise AssertionError(f"golden: {kernel} made {launches[kernel]} "
                                 f"launches for {counters.get(per, 0)} "
                                 f"{per}")
    print(json.dumps({"golden_profile": {
        "sanity_checks": True, "sync": True, "report_lines": len(report),
        "top": report[:REPORT_LINES]}}), flush=True)
    out["launches"] = {key: v for key, v in launches.items() if v}
    out["counters"] = counters
    print(json.dumps({"golden": out}), flush=True)
    return launches


def _golden_proofs(device) -> dict:
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    with open(GOLDEN_ARGS) as fh:
        golden_args = json.load(fh)
    t0 = time.time()
    params = Params.unsafe_setup(golden["k"], seed=golden["params_seed"],
                                 device=device)
    vk, pk = keygen(params, SimpleCircuit(), device=device)
    a, b = golden["a"], golden["b"]
    out = SimpleCircuit.expected_out(a, b)
    pv = params.verifier(1)
    for seed, want in golden["proofs"].items():
        proof = create_proof(params, pk, SimpleCircuit(a, b), [[out]],
                             seed=int(seed), device=device)
        if proof.hex() != want:
            raise AssertionError(
                f"golden proof bytes differ for seed {seed}")
        if not verify_proof(pv, vk, [[out]], proof):
            raise AssertionError(f"golden proof for seed {seed} rejected")
    args = {}
    for name, rec in golden_args["proofs"].items():
        circuit, planner = argument_circuit(name, rec["k"])
        params = Params.unsafe_setup(rec["k"], seed=rec["params_seed"],
                                     device=device)
        vk, pk = keygen(params, circuit, floor_planner=planner, device=device)
        if vk.pinned() != rec["pinned_vk"]:
            raise AssertionError(f"golden pinned vk differs for {name}")
        proof = create_proof(params, pk, circuit, rec["instances"],
                             seed=rec["prover_seed"], floor_planner=planner,
                             device=device)
        if proof.hex() != rec["proof_hex"]:
            raise AssertionError(f"golden proof bytes differ for {name}")
        if not verify_proof(params.verifier(1), vk, rec["instances"], proof):
            raise AssertionError(f"golden proof of {name} rejected")
        args[name] = {"k": rec["k"], "proof_bytes": len(proof)}
    multi = _golden_multi(device)
    return {"k": golden["k"], "seeds": sorted(golden["proofs"]),
            "arguments": args, "multi": multi, "bytes_equal": True,
            "verified": True, "seconds": round(time.time() - t0, 2)}


def _golden_multi(device) -> dict:
    """Every proof of torch_golden_multi.json on the card: the pinned vk,
    the proof bytes, the port's verifier; and the proof from the JAX
    package's witness file."""
    with open(GOLDEN_MULTI) as fh:
        golden = json.load(fh)
    out = {}
    keys = {}
    for name, rec in golden["proofs"].items():
        empty, circuits = multi_circuits(name, rec)
        at = (rec["k"], rec["params_seed"], type(empty).__name__)
        if at not in keys:
            params = Params.unsafe_setup(rec["k"], seed=rec["params_seed"],
                                         device=device)
            keys[at] = (params,) + keygen(params, empty, device=device)
        params, vk, pk = keys[at]
        if vk.pinned() != rec["pinned_vk"]:
            raise AssertionError(f"golden pinned vk differs for {name}")
        proof = create_proof_multi(params, pk, circuits, rec["instances"],
                                   seed=rec["prover_seed"],
                                   use_gwc=rec["use_gwc"], device=device)
        if proof.hex() != rec["proof_hex"]:
            raise AssertionError(f"golden proof bytes differ for {name}")
        if not verify_proof_multi(params.verifier(1), vk, rec["instances"],
                                  proof, use_gwc=rec["use_gwc"]):
            raise AssertionError(f"golden proof of {name} rejected")
        out[name] = {"k": rec["k"], "proofs": len(circuits),
                     "opening": "gwc" if rec["use_gwc"] else "shplonk",
                     "proof_bytes": len(proof)}
    files = golden["files"]
    params, vk, pk = keys[(files["k"], files["params_seed"], "SimpleCircuit")]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "witness.bin")
        with open(path, "wb") as fh:
            fh.write(bytes.fromhex(files["witness_hex"]))
        proof = create_proof_from_witness(params, pk, files["instances"],
                                          path, seed=files["prover_seed"],
                                          device=device)
    if proof.hex() != files["proof_hex"]:
        raise AssertionError("golden proof from the witness file differs")
    out["witness_file"] = {"k": files["k"], "proof_bytes": len(proof)}
    return out


def _reset_counts():
    for counts in (cuda_ops.launch_counts, cuda_point.launch_counts,
                   dm.launch_counts):
        for key in counts:
            counts[key] = 0


# the kernel families of the TPU kernels K1 and K4, by launch counter
FAMILIES = {"K1": ("binop", "pow", "inv", "scan"),
            "K4": ("point_op", "horner", "ladder", "fixed_base")}
FAMILY_LIMITS_K16 = {"K1": 6000, "K4": 1500}
# kernels no proof path launches: the 1:1 port of the Pallas scan step
# (the bucket scan took its place), pow (the square roots of a params
# file's points, on the load path; every inversion goes to inv) and the
# scalar ladder (setup multiplies the generator by the fixed-base comb)
OFF_PROVE_PATH = ("add_mixed_packed", "pow", "ladder")
# launches of the fixed-base comb a path makes: unsafe_setup's g and
# g_lagrange
SETUP_FIXED_BASE = 2
# each MSM kernel's launches equal a counter: one scan a window group, one
# Horner combine a call, one bucket launch a batch of columns
LAUNCHES_PER_COUNTER = (("msm_scan", "msm_window_groups"),
                        ("horner", "horner_calls"),
                        ("msm_bucket", "msm_bucket_calls"))


def _check_path_launches(name, n, launches, counters):
    """The launch checks of a driven path of n rows: every kernel
    launched but those the path never launches (OFF_PROVE_PATH and the MSM
    kernel of the other size: every commitment of the path is an MSM of n
    points, which takes the bucket path below SORT_BLOCK points and the
    sorted path's scan from there on), which must have none; the
    fixed-base comb twice; each MSM kernel once a unit of its counter."""
    off = OFF_PROVE_PATH + (("msm_scan",) if n < SORT_BLOCK
                            else ("msm_bucket",))
    for kernel, count in launches.items():
        if count <= 0 and kernel not in off:
            raise AssertionError(f"{name}: kernel {kernel} was never "
                                 f"launched on the path")
    for kernel in off:
        if launches[kernel]:
            raise AssertionError(f"{name}: kernel {kernel} was launched "
                                 f"{launches[kernel]} times on the path")
    if launches["fixed_base"] != SETUP_FIXED_BASE:
        raise AssertionError(f"{name}: fixed_base made "
                             f"{launches['fixed_base']} launches, expected "
                             f"{SETUP_FIXED_BASE} (setup's two bases)")
    for kernel, per in LAUNCHES_PER_COUNTER:
        if launches[kernel] != counters.get(per, 0):
            raise AssertionError(f"{name}: {kernel} made {launches[kernel]} "
                                 f"launches for {counters.get(per, 0)} "
                                 f"{per}")


def _rejects(pv, vk, instances_list, proof, use_gwc=True) -> bool:
    try:
        return not verify_proof_multi(pv, vk, instances_list, proof,
                                      use_gwc=use_gwc)
    except ValueError:
        return True


def _drive(name, k, seed, device, circuits, instances_list,
           floor_planner=None, extra=None, family_limits=None,
           use_gwc=True, after=None, offload_lagrange=False,
           peaks=False, min_counters=None) -> dict:
    """unsafe_setup -> keygen -> create_proof_multi -> verify_proof_multi
    for one or more instances of one circuit, with every launch count set
    to 0 just before and read just after; a proof with one byte flipped
    and wrong instances (swapped where the proofs' differ, else one
    altered) must be rejected, and BatchVerifier must accept.  Then
    `after(params, vk, pk, proof)`, whose dict joins the path's JSON line
    (with `extra`).  Prints the line and returns the path's launches; fails
    where a family of kernels launched more than `family_limits` gives
    it, or where a counter of `min_counters` stayed below its least value.
    With `peaks` every phase's peak allocated and reserved bytes are read
    at its end (and the device's peak statistics reset there)."""
    torch.cuda.reset_peak_memory_stats(device)
    profiling.reset()
    _reset_counts()                          # the path starts here
    phases = profiling.PhaseTimes(device, peaks=peaks)
    setup_phases = profiling.PhaseTimes(device)
    params = Params.unsafe_setup(k, seed=seed, device=device,
                                 phases=setup_phases)
    phases("unsafe_setup")
    vk, pk = keygen(params, circuits[0], floor_planner=floor_planner,
                    device=device)
    phases("keygen")
    prover_phases = profiling.PhaseTimes(device, peaks=peaks)
    proof = create_proof_multi(params, pk, circuits, instances_list,
                               seed=seed + 1, floor_planner=floor_planner,
                               use_gwc=use_gwc, device=device,
                               phases=prover_phases,
                               offload_lagrange=offload_lagrange)
    phases("create_proof")
    launches = {**cuda_ops.launch_counts, **cuda_point.launch_counts}
    launches = dict(launches)                # and ends here
    peak = torch.cuda.max_memory_allocated(device)
    if peaks:
        # the prover's marks reset the statistics: its own phases hold
        # its peaks, and the outer "create_proof" entry is dropped
        del phases.peaks["create_proof"]
        peak_by_phase = {**phases.peaks, **prover_phases.peaks}
        peak = max(p["allocated"] for p in peak_by_phase.values())
    families = {fam: sum(launches[c] for c in counters)
                for fam, counters in FAMILIES.items()}
    counters = dict(profiling.counters)
    pv = params.verifier(1)
    ok = verify_proof_multi(pv, vk, instances_list, proof, use_gwc=use_gwc)
    phases("verify_proof")
    batch = BatchVerifier(seed=seed)
    verify_proof_multi(pv, vk, instances_list, proof, use_gwc=use_gwc,
                       strategy=batch)
    batch_ok = batch.finalize(pv)
    tampered = bytearray(proof)
    tampered[-40] ^= 1
    tampered_rejected = _rejects(pv, vk, instances_list, bytes(tampered),
                                 use_gwc)
    if len(instances_list) > 1 and instances_list[0] != instances_list[-1]:
        wrong = instances_list[::-1]
    else:
        wrong = [[[(v + 1) % P for v in col] for col in instances_list[0]]]
        wrong += instances_list[1:]
    wrong_rejected = _rejects(pv, vk, wrong, proof, use_gwc)
    if not ok:
        raise AssertionError(f"{name}: the proof was rejected")
    if not batch_ok:
        raise AssertionError(f"{name}: BatchVerifier rejected the proof")
    if not tampered_rejected:
        raise AssertionError(f"{name}: a tampered proof was accepted")
    if not wrong_rejected:
        raise AssertionError(f"{name}: a wrong instance was accepted")
    _check_path_launches(name, 1 << k, launches, counters)
    for counter, least in (min_counters or {}).items():
        if counters.get(counter, 0) < least:
            raise AssertionError(f"{name}: counter {counter} is "
                                 f"{counters.get(counter, 0)}, expected at "
                                 f"least {least}")
    more = after(params, vk, pk, proof) if after else {}
    if peaks:
        more["peak_bytes_by_phase"] = {**phases.peaks,
                                       **prover_phases.peaks}
    cs = vk.cs
    print(json.dumps({name: {
        "k": k, "rows": 1 << k, "usable_rows": cs.usable_rows(1 << k),
        **(extra or {}),
        "proofs": len(circuits), "opening": "gwc" if use_gwc else "shplonk",
        "degree": cs.degree(), "extended_k": vk.domain.extended_k,
        "advice_columns": cs.num_advice_columns,
        "fixed_columns": cs.num_fixed_columns,
        "lookup_sets": [len(lk.input_expressions_sets) for lk in cs.lookups],
        "shuffle_units": [len(g.units) for g in cs.shuffles],
        "range_checks": len(cs.range_check),
        "proof_bytes": len(proof), "verified": ok,
        "batch_verified": batch_ok,
        "tampered_rejected": tampered_rejected,
        "wrong_instance_rejected": wrong_rejected,
        "seconds": {n_: round(s, 3) for n_, s in phases.seconds.items()},
        "unsafe_setup_seconds": {n_: round(s, 3) for n_, s
                                 in setup_phases.seconds.items()},
        "create_proof_seconds": {n_: round(s, 3) for n_, s
                                 in prover_phases.seconds.items()},
        "launches": launches, "launches_by_family": families,
        "counters": counters, "peak_memory_bytes": peak, **more}}),
        flush=True)
    for fam, most in (family_limits or {}).items():
        if families[fam] > most:
            raise AssertionError(f"{name}: {fam} made {families[fam]} "
                                 f"launches, more than {most}")
    return launches


def phase_prove(k: int, seed: int, device) -> dict:
    """A row-filling chain of mul gates (gates + permutation)."""
    circuit = MulChainCircuit(MulChainCircuit.steps_for(k), a=3, b=5)
    return _drive("prove", k, seed, device, [circuit],
                  [[[circuit.expected_out()]]],
                  extra={"rows_assigned": 2 * circuit.steps},
                  family_limits=FAMILY_LIMITS_K16 if k == 16 else None)


def phase_args(k: int, seed: int, device) -> dict:
    """Every argument in one proof: AllArgsCircuit over all usable rows."""
    circuit = AllArgsCircuit(AllArgsCircuit.usable_rows(k))
    return _drive("args", k, seed, device, [circuit],
                  [[[circuit.instance()]]], FlatFloorPlanner)


def _file_round_trip(circuit, instances, seed, device, load_launches):
    """`after` of the multi path: params, circuit data, vk and the
    witness of `circuit` to files and back; the proof from the witness
    file on the reloaded key against create_proof on the in-memory one
    (SHPLONK, one seed), and the reloaded vk verifying it.  The loads are
    the load path: their launches go into `load_launches`, and the
    square roots of the params' points must launch pow."""
    def run(params, vk, pk, proof):
        t0 = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            path = {f: os.path.join(tmp, f) for f in
                    ("params.bin", "cd.npz", "vk.bin", "witness.bin")}
            h2io.save_params(params, path["params.bin"])
            h2io.save_circuit_data(pk, path["cd.npz"])
            h2io.save_vk(vk, path["vk.bin"])
            create_witness(pk, circuit, instances, path["witness.bin"],
                           floor_planner=FlatFloorPlanner)
            sizes = {f: os.path.getsize(p_) for f, p_ in path.items()}
            written = time.time()
            _reset_counts()                  # the load path starts here
            params2 = h2io.load_params(path["params.bin"], device=device)
            vk2, pk2 = h2io.load_circuit_data(params2, path["cd.npz"])
            vk3 = h2io.load_vk(params2, circuit, path["vk.bin"],
                               floor_planner=FlatFloorPlanner)
            torch.cuda.synchronize()
            load_launches.update(cuda_ops.launch_counts)
            load_launches.update(cuda_point.launch_counts)  # and ends here
            loaded = time.time()
            from_file = create_proof_from_witness(
                params2, pk2, instances, path["witness.bin"], seed=seed,
                use_gwc=False, device=device)
        proved = time.time()
        direct = create_proof(params, pk, circuit, instances, seed=seed,
                              floor_planner=FlatFloorPlanner, use_gwc=False,
                              device=device)
        if from_file != direct:
            raise AssertionError("multi: the proof from the witness file "
                                 "differs from create_proof's")
        if not vk2.pinned() == vk3.pinned() == vk.pinned():
            raise AssertionError("multi: a reloaded vk differs")
        if not verify_proof(params2.verifier(1), vk3, instances, from_file,
                            use_gwc=False):
            raise AssertionError("multi: the reloaded vk rejected the proof")
        if load_launches["pow"] < 1:
            raise AssertionError("multi: loading the params launched no pow")
        return {"file_round_trip": {
            "bytes": sizes, "bytes_equal": True, "verified": True,
            "load_launches": {k_: v for k_, v in load_launches.items()
                              if v},
            "seconds": {"write": round(written - t0, 3),
                        "load": round(loaded - written, 3),
                        "create_proof_from_witness": round(proved - loaded,
                                                           3)}}}
    return run


def phase_multi(k: int, seed: int, device):
    """Two AllArgsCircuit instances over all usable rows in one SHPLONK
    proof, then the file round trip of instance 0: the launches of the
    proof's path and of the load path."""
    rows = AllArgsCircuit.usable_rows(k)
    circuits = [AllArgsCircuit(rows, seed=s) for s in MULTI_SEEDS]
    instances = [[[c.instance()]] for c in circuits]
    cs = ConstraintSystem()
    circuits[0].configure(cs)
    cs.chunk_lookups()
    cs.chunk_shuffles()
    load_launches = {}
    launches = _drive("multi", k, seed, device, circuits, instances,
                      FlatFloorPlanner, use_gwc=False,
                      extra={"witness_seeds": list(MULTI_SEEDS),
                             "shplonk_sets": {str(list(r)): c for r, c in
                                              _shplonk_sets(cs, 2).items()}},
                      after=_file_round_trip(circuits[0], instances[0],
                                             seed + 2, device, load_launches))
    return launches, load_launches


# the synth path: BlockMulChainCircuit's blocks (regions handed to the
# forked workers) and its witness (a small, so that the first region leaves
# column a0 a u64 column; b a machine int above 2^16, so that x passes 2^64
# within a few steps and a0 degrades in the overflow merge)
SYNTH_BLOCKS = 64
SYNTH_AB = (3, 1000003)


def _same_columns(xs, ys) -> bool:
    """Equal witness columns: the same kind (u64 array or ints) and the
    same values."""
    for x, y in zip(xs, ys):
        if isinstance(x, np.ndarray) != isinstance(y, np.ndarray):
            return False
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
        elif list(x) != list(y):
            return False
    return len(xs) == len(ys)


def _synth_checks(circuit_of, instances, seed, device):
    """`after` of the synth path: the witness of 1 and of default_workers()
    workers (seconds of synthesize_witness alone, equal columns), the proof
    of one worker against the path's proof (made with W workers, same
    seed), the witness files of both, and the degraded column's export by
    the host codec against the plain Python join."""
    def run(params, vk, pk, proof):
        workers = default_workers()
        if workers < 2:
            raise AssertionError("synth: default_workers() is 1 on this "
                                 "machine, nothing runs in parallel")
        seconds, advice = {}, {}
        for w in (1, workers):
            fan_outs = profiling.counters.get("synth_fan_outs", 0)
            t0 = time.time()
            advice[w], _ = synthesize_witness(pk, circuit_of(w), instances,
                                              FlatFloorPlanner)
            seconds[w] = time.time() - t0
            forked = profiling.counters.get("synth_fan_outs", 0) - fan_outs
            if forked != (0 if w == 1 else 1):
                raise AssertionError(f"synth: {w} workers made {forked} "
                                     f"fan-outs")
        if not _same_columns(advice[1], advice[workers]):
            raise AssertionError("synth: the witness of 1 and of "
                                 f"{workers} workers differ")
        t0 = time.time()
        proof1 = create_proof(params, pk, circuit_of(1), instances,
                              seed=seed + 1, floor_planner=FlatFloorPlanner,
                              device=device)
        proof1_s = time.time() - t0
        if proof1 != proof:
            raise AssertionError("synth: the proof of 1 worker differs from "
                                 f"the proof of {workers}")
        files = {}
        with tempfile.TemporaryDirectory() as tmp:
            for w in (1, workers):
                path = os.path.join(tmp, f"witness{w}.bin")
                create_witness(pk, circuit_of(w), instances, path,
                               floor_planner=FlatFloorPlanner)
                with open(path, "rb") as fh:
                    files[w] = fh.read()
        if files[1] != files[workers]:
            raise AssertionError("synth: the witness files of 1 and of "
                                 f"{workers} workers differ")
        degraded = [c for c in advice[workers]
                    if not isinstance(c, np.ndarray)]
        if not degraded:
            raise AssertionError("synth: no column went past 2^64")
        col = degraded[0]
        t0 = time.time()
        blob = native.longs_to_blob(col, P)
        codec_s = time.time() - t0
        t0 = time.time()
        plain = native.plain_longs_to_blob(col, P)
        plain_s = time.time() - t0
        if blob != plain:
            raise AssertionError("synth: the codec's export of the degraded "
                                 "column differs from the plain join")
        return {"synthesis": {
            "cpu_count": os.cpu_count(),
            "cpus_available": len(os.sched_getaffinity(0)),
            "workers": workers,
            "synthesize_witness_seconds": {str(w): round(s_, 3)
                                           for w, s_ in seconds.items()},
            "witness_equal": True, "proof_equal": True,
            "create_proof_seconds_1_worker": round(proof1_s, 3),
            "witness_file_bytes": len(files[1]), "witness_files_equal": True,
            "degraded_columns": len(degraded),
            "codec": {"values": len(col), "blob_bytes": len(blob),
                      "longs_to_blob_seconds": round(codec_s, 4),
                      "plain_join_seconds": round(plain_s, 4),
                      "bytes_equal": True}}}
    return run


def phase_synth(k: int, seed: int, device) -> dict:
    """BlockMulChainCircuit at 2^k rows: keygen on the card, its blocks
    synthesized by forked workers, proved and verified, then the checks of
    _synth_checks."""
    steps = BlockMulChainCircuit.steps_for(k, SYNTH_BLOCKS)
    a, b = SYNTH_AB

    def circuit_of(workers):
        return BlockMulChainCircuit(steps, SYNTH_BLOCKS, a, b,
                                    workers=workers)
    circuit = circuit_of(None)               # default_workers()
    instances = [[circuit.expected_out()]]
    return _drive("synth", k, seed, device, [circuit], [instances],
                  FlatFloorPlanner,
                  extra={"blocks": SYNTH_BLOCKS,
                         "rows_assigned": circuit.rows_used()},
                  after=_synth_checks(circuit_of, instances, seed, device))


def _large_checks(k: int, device):
    """`after` of the large path: the identities of
    examples/torch_probe_k22.py at 2^k on the path's SRS, and the streamed
    extended inverse transform against the monolithic one at 2^(k+1)."""
    def run(params, vk, pk, proof):
        x = probe_k22.random_column(k, device)
        ntt = get_ntt(k, device)
        records = [probe_k22.identity_a(ntt, x),
                   probe_k22.identity_b(params, ntt, x),
                   probe_k22.identity_c(x)]
        del x
        ext = get_ntt(k + 1, device)
        records.append(probe_k22.streamed_against_monolithic(
            ext, probe_k22.random_column(k + 1, device), STREAM_CHUNKS_LOG))
        ext.drop_tables()
        for rec in records:
            if not rec["ok"]:
                raise AssertionError(f"large: identity {rec['identity']} "
                                     f"fails at 2^{k}")
        return {"identities": records}
    return run


def phase_large(k: int, seed: int, device) -> dict:
    """MulChainCircuit at 2^k rows through the large-domain sequence, with
    the offloads, then _large_checks."""
    circuit = MulChainCircuit(MulChainCircuit.steps_for(k), a=3, b=5)
    return _drive("large", k, seed, device, [circuit],
                  [[[circuit.expected_out()]]],
                  extra={"rows_assigned": 2 * circuit.steps,
                         "offload_lagrange": True, "large_n": LARGE_N,
                         "stream_ntt_min": STREAM_NTT_MIN},
                  after=_large_checks(k, device), offload_lagrange=True,
                  peaks=True, min_counters={"ntt_streamed_calls": 1,
                                            "lagrange_offloads": 2})


def _load_dft_probe():
    spec = importlib.util.spec_from_file_location("torch_mxu_dft_probe",
                                                  DFT_PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DFT_SIZES = (16, 64)
DFT_B = 1 << 17


def phase_dft(device, smi: str):
    """The probe's path at m = 16 and 64: returns K6's entry for the
    kernels line and the launches of that path."""
    probe = _load_dft_probe()
    t0 = time.time()
    cases = {m: (dm.dft_matrices(m, device),
                 probe.probe_input(m, DFT_B, device)) for m in DFT_SIZES}
    _reset_counts()                          # the probe's path starts here
    outs = {m: dm.dft_matmul(x, mats[0], mats[1], m)
            for m, (mats, x) in cases.items()}
    torch.cuda.synchronize()
    launches = dict(dm.launch_counts)        # and ends here
    if launches["dft_epilogue"] <= 0:
        raise AssertionError("kernel dft_epilogue was never launched on the "
                             "probe's path")
    results, worst = {}, 0
    for m, (mats, x) in cases.items():
        res = probe.check(x, outs[m], mats, m)
        worst = max(worst, res["epilogue_max_abs_err"])
        # a ragged B, checked the same way
        xr = probe.probe_input(m, 1000, device, seed=1)
        ragged = probe.check(xr, dm.dft_matmul(xr, mats[0], mats[1], m),
                             mats, m)
        worst = max(worst, ragged["epilogue_max_abs_err"])
        # the largest sums these shapes allow, and zero, in every carry
        # position: the value is sum_t 17 v 2^(8t)
        for v in (m * dm.NB * 15 * 255, 0):
            s_ = torch.full((m * dm.NB, 1000), float(v), dtype=torch.float32,
                            device=device)
            got = dm.dft_epilogue(s_, s_, m)
            worst = max(worst, _max_err(
                got, dm.plain_dft_epilogue(s_, s_, m)))
            want = sum(17 * v << (8 * t) for t in range(dm.NB)) % dm.P
            have = limbs_to_ints(got[:, :, 0].cpu().numpy())
            if any(h % dm.P != want or h >= 1 << 271 for h in have):
                raise AssertionError(f"m={m}: K6 on the sums {v} is not "
                                     f"congruent to their value")
        res["ragged_B1000"] = {k: ragged[k] for k in (
            "exact_mod_p", "ntt_agrees", "epilogue_max_abs_err")}
        res.update(probe.measure(m, DFT_B, x, mats))
        results[m] = res
    if worst != 0:
        raise AssertionError(f"kernel dft_epilogue disagrees with its plain "
                             f"version: max abs err {worst}")
    print(json.dumps({"dft": {
        "card": smi, "sizes": results, "launches": launches,
        "seconds": round(time.time() - t0, 2)}}), flush=True)

    def variant(m):
        r = results[m]
        return {"variant": f"m={m}", "B": DFT_B,
                "ms": r["ms"]["epilogue_k6"],
                "device_ms": r["ms"]["epilogue_k6_device"],
                "plain_ms": r["ms"]["epilogue_plain"],
                "bound_ms": r["bound_ms"]["epilogue_k6"],
                "bound_by": r["bound_by"]["epilogue_k6"],
                "products_ms": r["ms"]["products"],
                "products_bound_ms": r["bound_ms"]["products"]}
    head = variant(DFT_SIZES[0])
    entry = {
        "name": "dft_epilogue", "route": "cuda",
        "source": "halo2_tpu_torch/csrc/dft_kernels.cu",
        "replaces": "examples/mxu_dft_probe.py:175",
        "max_abs_err": worst, "ms": head["ms"],
        "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "products_ms": head["products_ms"],
        "shape": f"lo, hi ({DFT_SIZES[0] * dm.NB}, {DFT_B}) float32 -> "
                 f"(17, {DFT_SIZES[0]}, {DFT_B})",
        "launches_from": "the dft phase (dft_matmul at m = 16 and 64); the "
                         "prove, args and multi paths launch it 0 times",
        "variants": [variant(m) for m in DFT_SIZES]}
    return entry, launches


# the mesh path: D logical shards placed on cuda:(i % device_count), the
# k-row AllArgsCircuit proved with params.use_mesh
MESH_SHARDS = 4


def _card_mesh() -> Mesh:
    count = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i % count)
                 for i in range(MESH_SHARDS)])


# the wrappers whose shapes the mesh changes (shard shapes, the local
# transforms of the four-step, the tree over the shards' window totals):
# each call on the mesh path records its shapes; the grand products' inv
# and scan and the setup's scalars and fixed-base comb run whole on the
# first device, at the args path's shapes
MESH_RECORDED = (
    (cuda_ops, "binop", lambda op, field, a, b:
     (op, field.name, tuple(a.shape), tuple(b.shape))),
    (cuda_ops, "butterfly", lambda field, lo, hi, tw, rep=1:
     (tuple(lo.shape), tuple(tw.shape), rep)),
    (cuda_ops, "mul_tiled", lambda field, a, t:
     (tuple(a.shape), tuple(t.shape))),
    (cuda_point, "point_op", lambda op, coords:
     (op, len(coords), tuple(coords[0].shape))),
    (cuda_point, "msm_scan", lambda rows, order, key, block, nb:
     (tuple(order.shape), block, nb)),
    (cuda_point, "horner", lambda totals, c_bits, tail_doubles=0:
     (tuple(totals[0].shape), c_bits, tail_doubles)))
MESH_KERNEL_NAME = {"binop": "field_binop", "butterfly": "ntt_butterfly",
                    "mul_tiled": "mul_tiled", "point_op": "point_op",
                    "msm_scan": "msm_scan", "horner": "point_horner"}


def _recorded(fn, record: dict):
    """fn() with each MESH_RECORDED wrapper adding the key of every call
    to record[wrapper name] (a set); the wrappers are restored after."""
    saved = []
    for mod, name, key in MESH_RECORDED:
        orig = getattr(mod, name)
        seen = record.setdefault(name, set())

        def wrapped(*args, _orig=orig, _key=key, _seen=seen, **kw):
            _seen.add(_key(*args, **kw))
            return _orig(*args, **kw)
        saved.append((mod, name, orig))
        setattr(mod, name, wrapped)
    try:
        return fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def _replay(record: dict, gen, device) -> dict:
    """Each recorded call shape again on random inputs, kernel against
    plain version: {wrapper: {"shapes": n, "max_abs_err": worst}}."""
    Fr_, Fq_ = fr(device), fq(device)
    fields = {"Fr": Fr_, "Fq": Fq_}
    out = {}

    def rnd(F, shape):
        return _rand_field(F, shape, gen)

    for name, keys in record.items():
        worst = 0
        for key in sorted(keys, key=str):
            if name == "binop":
                op, fname, sa, sb = key
                if 0 in sa or 0 in sb:
                    continue
                F = fields[fname]
                a, b = rnd(F, sa[1:]), rnd(F, sb[1:])
                err = _max_err(cuda_ops.binop(op, F, a, b),
                               cuda_ops.plain_op(op, F, a, b))
            elif name == "butterfly":
                (_, mid, half), (_, k_), rep = key
                x = rnd(Fr_, (mid, 2, half))
                tw = rnd(Fr_, (k_,))
                lo, hi = x[:, :, 0, :], x[:, :, 1, :]
                err = _max_err(cuda_ops.butterfly(Fr_, lo, hi, tw, rep),
                               cuda_ops.plain_butterfly(Fr_, lo, hi, tw,
                                                        rep))
            elif name == "mul_tiled":
                sa, st = key
                a, t = rnd(Fr_, sa[1:]), rnd(Fr_, st[1:])
                mid = a.numel() // (N_LIMBS * st[1])
                err = _max_err(cuda_ops.mul_tiled(Fr_, a, t),
                               cuda_ops.plain_mul_tiled(
                                   Fr_, a.reshape(N_LIMBS, mid, st[1]),
                                   t).reshape(a.shape))
            elif name == "point_op":
                op, count, shape = key
                # the kernel reads a batch flat: (16, N)
                lanes = int(np.prod(shape[1:]))
                coords = [rnd(Fq_, (lanes,)) for _ in range(count)]
                err = _max_err(cuda_point.point_op(op, coords),
                               cuda_point.plain_point_op(op, coords))
            elif name == "msm_scan":
                (G, n), block, nb = key
                c = (nb - 1).bit_length()
                rows = msm_sorted.pack_xy(rnd(Fq_, (n,)), rnd(Fq_, (n,))) \
                    .t().contiguous()
                order, skey = _scan_inputs(gen, device, G, n, c, "scalars")
                err = _max_err(
                    _flat_scan(cuda_point.msm_scan(rows, order, skey, block,
                                                   nb)),
                    _flat_scan(cuda_point.plain_msm_scan(rows, order, skey,
                                                         block, nb)))
            else:                                    # horner
                shape, c_bits, tail = key
                totals = tuple(rnd(Fq_, shape[1:]) for _ in range(3))
                err = _max_err(cuda_point.horner(totals, c_bits, tail),
                               g1.plain_horner(totals, c_bits, tail))
            worst = max(worst, err)
        out[name] = {"shapes": len(keys), "max_abs_err": worst}
    return out


def _mesh_primitives(mesh, ext_k: int, cols: int, rot_scale: int,
                     blinders: int, gen, device) -> dict:
    """DistNTT at the args path's extended size, batched as evaluate_h
    extends the advice; the sharded MSM over 2^16 SRS-like points, full
    and bounded; dist_roll on every (q, r) branch — each exact against
    its single-device counterpart."""
    Fr_ = fr(device)
    out = {}
    n = 1 << ext_k
    x = _rand_field(Fr_, (cols, n), gen)
    dist = DistNTT(ext_k, mesh)
    ntt = get_ntt(ext_k, device)
    for name in ("forward", "inverse", "inverse_nodiv"):
        got = getattr(dist, name)(x).gather()
        if not torch.equal(got, getattr(ntt, name)(x)):
            raise AssertionError(f"mesh: DistNTT.{name} differs from NTT at "
                                 f"2^{ext_k}")
    out["dist_ntt"] = {
        "ext_k": ext_k, "columns": cols, "equal": True,
        "ms": _time_cuda(lambda: dist.forward(x), 5),
        "single_ms": _time_cuda(lambda: ntt.forward(x), 5)}
    dist.drop_tables()
    ntt.drop_tables()
    m = 1 << 16
    aff, _ = _rand_points(m, gen, device)
    full = _rand_field(Fr_, (m,), gen)
    short_std = torch.zeros((N_LIMBS, m), dtype=torch.int32, device=device)
    short_std[0] = torch.randint(0, 1 << 16, (m,), dtype=torch.int32,
                                 device=device, generator=gen)
    short = Fr_.to_mont(short_std)
    cols_, bits = [full, short], [256, 16]
    got = g1.decode_points(g1.to_affine(msm_many_sharded(
        aff, cols_, mesh, "x", bits)))
    want = g1.decode_points(g1.to_affine(msm_many(aff, cols_, bits)))
    if got != want:
        raise AssertionError("mesh: the sharded MSM differs from msm_many")
    out["msm_sharded"] = {
        "points": m, "columns": ["full", "16-bit, max_bits 16"],
        "equal": True,
        "ms": _time_cuda(lambda: msm_many_sharded(aff, cols_, mesh, "x",
                                                  bits), 3),
        "single_ms": _time_cuda(lambda: msm_many(aff, cols_, bits), 3)}
    devices = mesh.devices_of("x")
    L = n // len(devices)
    shifts = [0, 5, L, 3 * L % n, 2 * L + 7, n - 1, n - 3, n + 11,
              rot_scale, -(blinders + 1) * rot_scale]
    col = _rand_field(Fr_, (3, n), gen)
    shards = list(col.chunk(len(devices), dim=-1))
    for s in shifts:
        if not torch.equal(torch.cat(dist_roll(shards, devices, s), dim=-1),
                           torch.roll(col, -s, dims=-1)):
            raise AssertionError(f"mesh: dist_roll by {s} differs from "
                                 f"torch.roll")
    out["dist_roll"] = {"ext_n": n, "shifts": shifts, "equal": True}
    return out


def phase_mesh(k: int, seed: int, device) -> dict:
    """AllArgsCircuit at 2^k rows proved over a mesh of MESH_SHARDS shards
    (params.use_mesh) and on one device, same seed: the same bytes, the
    port's verifier and BatchVerifier accept, a tampered proof is
    rejected; the mesh path's launches (setup, keygen and the sharded
    proof, counts set to 0 just before and read just after), every
    wrapper at the shapes it was called with there held to its plain
    version, the primitives against their single-device counterparts,
    seconds by phase of both proofs and peak bytes per device."""
    mesh = _card_mesh()
    devices = [str(d) for d in mesh.flat]
    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    t0 = time.time()
    circuit = AllArgsCircuit(AllArgsCircuit.usable_rows(k))
    instances = [[circuit.instance()]]
    sh = _shapes(k, "mesh", circuit)
    cs = ConstraintSystem()
    circuit.configure(cs)
    primitives = _mesh_primitives(
        mesh, sh["ext_k"], cs.num_advice_columns, sh["ext_n"] // sh["n"],
        cs.blinding_factors(), gen, device)
    distinct = sorted(set(devices))
    record = {}
    # what earlier phases left allocated: the peaks below include it
    before = {d: torch.cuda.memory_allocated(d) for d in distinct}
    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)
    profiling.reset()
    _reset_counts()                          # the mesh path starts here
    phases = profiling.PhaseTimes(device)
    sharded_phases = profiling.PhaseTimes(device)
    setup_phases = profiling.PhaseTimes(device)

    def run():
        params = Params.unsafe_setup(k, seed=seed, device=device,
                                     phases=setup_phases)
        params.use_mesh(mesh)
        phases("unsafe_setup")
        vk, pk = keygen(params, circuit, floor_planner=FlatFloorPlanner,
                        device=device)
        phases("keygen")
        proof = create_proof(params, pk, circuit, instances, seed=seed + 1,
                             floor_planner=FlatFloorPlanner, device=device,
                             phases=sharded_phases)
        phases("create_proof sharded")
        return params, vk, pk, proof
    params, vk, pk, proof = _recorded(run, record)
    launches = dict({**cuda_ops.launch_counts, **cuda_point.launch_counts})
    counters = dict(profiling.counters)      # and ends here
    peaks = {d: torch.cuda.max_memory_allocated(d) for d in distinct}
    params.use_mesh(None)
    _reset_counts()
    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)
    single_phases = profiling.PhaseTimes(device)
    single = create_proof(params, pk, circuit, instances, seed=seed + 1,
                          floor_planner=FlatFloorPlanner, device=device,
                          phases=single_phases)
    phases("create_proof single")
    single_peaks = {d: torch.cuda.max_memory_allocated(d) for d in distinct}
    single_launches = {key: v for key, v in {
        **cuda_ops.launch_counts, **cuda_point.launch_counts}.items() if v}
    if proof != single:
        raise AssertionError("mesh: the sharded proof differs from the "
                             "single-device proof of the same seed")
    # the sharded proof again, warm as the single one was, with its own
    # launches and peaks
    params.use_mesh(mesh)
    _reset_counts()
    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)
    warm_phases = profiling.PhaseTimes(device)
    again = create_proof(params, pk, circuit, instances, seed=seed + 1,
                         floor_planner=FlatFloorPlanner, device=device,
                         phases=warm_phases)
    phases("create_proof sharded warm")
    warm_peaks = {d: torch.cuda.max_memory_allocated(d) for d in distinct}
    warm_launches = {key: v for key, v in {
        **cuda_ops.launch_counts, **cuda_point.launch_counts}.items() if v}
    params.use_mesh(None)
    if again != single:
        raise AssertionError("mesh: the warm sharded proof differs")
    pv = params.verifier(1)
    ok = verify_proof_multi(pv, vk, [instances], proof)
    batch = BatchVerifier(seed=seed)
    verify_proof_multi(pv, vk, [instances], proof, strategy=batch)
    batch_ok = batch.finalize(pv)
    tampered = bytearray(proof)
    tampered[-40] ^= 1
    if not (ok and batch_ok):
        raise AssertionError("mesh: the sharded proof was rejected")
    if not _rejects(pv, vk, [instances], bytes(tampered)):
        raise AssertionError("mesh: a tampered proof was accepted")
    _check_path_launches("mesh", 1 << k, launches, counters)
    if counters.get("dist_ntt_calls", 0) < 1:
        raise AssertionError("mesh: no transform went over the mesh")
    replay = _replay(record, gen, device)
    for name, r in replay.items():
        if r["max_abs_err"]:
            raise AssertionError(f"mesh: {name} disagrees with its plain "
                                 f"version at a mesh shape")
    crossed = len(distinct) > 1
    print(json.dumps({"mesh": {
        "k": k, "rows": 1 << k, "shards": MESH_SHARDS,
        "devices": devices, "device_count": torch.cuda.device_count(),
        "extended_k": vk.domain.extended_k, "proof_bytes": len(proof),
        "bytes_equal_single_device": True, "verified": ok,
        "batch_verified": batch_ok, "tampered_rejected": True,
        "primitives": primitives,
        "seconds": {n_: round(s, 3) for n_, s in phases.seconds.items()},
        "unsafe_setup_seconds": {n_: round(s, 3) for n_, s
                                 in setup_phases.seconds.items()},
        "create_proof_seconds": {
            "sharded": {n_: round(s, 3)
                        for n_, s in sharded_phases.seconds.items()},
            "single": {n_: round(s, 3)
                       for n_, s in single_phases.seconds.items()},
            "sharded_warm": {n_: round(s, 3)
                             for n_, s in warm_phases.seconds.items()}},
        "launches": launches,
        "proof_launches": {"sharded_warm": warm_launches,
                           "single": single_launches},
        "counters": counters,
        "peak_allocated_bytes_by_device": {
            "allocated_before": before, "mesh_path": peaks,
            "single_proof": single_peaks, "sharded_warm_proof": warm_peaks},
        "mesh_shapes": replay,
        "seconds_total": round(time.time() - t0, 2)}}), flush=True)
    print(json.dumps({"mesh_copies_crossed_cards": crossed}), flush=True)
    return launches, replay


LAUNCH_KEY = {"field_binop": "binop", "ntt_butterfly": "butterfly",
              "mul_tiled": "mul_tiled", "field_pow": "pow",
              "field_inv": "inv", "field_scan": "scan", "point_op": "point_op",
              "add_mixed_packed": "add_mixed_packed",
              "msm_scan": "msm_scan", "point_horner": "horner",
              "point_ladder": "ladder", "fixed_base": "fixed_base",
              "msm_bucket": "msm_bucket", "dft_epilogue": "dft_epilogue",
              "decode_le32": "decode_le32"}
ALL_PHASES = "env,kernels,golden,prove,args,multi,synth,large,mesh,dft"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=16,
                    help="log2 of the rows of the prove phase (default 16)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="comma-separated subset, for a shorter run; the "
                         "last line is only printed after a full run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phases = set(args.phases.split(","))
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.zeros(1, device=device)            # the context exists from here on
    out = {}
    phase_env(out)
    entries = phase_kernels(args.k, device, out["ptxas"]) \
        if "kernels" in phases else []
    paths = {}                               # path -> its launch counts
    if "golden" in phases:
        paths["golden"] = phase_golden(device)
    if "prove" in phases:
        paths["prove"] = phase_prove(args.k, args.seed, device)
    if "args" in phases:
        paths["args"] = phase_args(args.k, args.seed, device)
    if "multi" in phases:
        paths["multi"], paths["load"] = phase_multi(args.k, args.seed, device)
    if "synth" in phases:
        paths["synth"] = phase_synth(args.k, args.seed, device)
    if "large" in phases:
        paths["large"] = phase_large(LARGE_K, args.seed, device)
    mesh_replay = {}
    if "mesh" in phases:
        paths["mesh"], mesh_replay = phase_mesh(args.k, args.seed, device)
    if "dft" in phases:
        entry, paths["dft"] = phase_dft(device, out["smi"])
        entries.append(entry)
    for wrapper, r in mesh_replay.items():
        for e in entries:
            if e["name"] == MESH_KERNEL_NAME[wrapper]:
                e["mesh_shapes"] = r
                e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
    for e in entries:
        by_path = {path: counts.get(LAUNCH_KEY[e["name"]], 0)
                   for path, counts in paths.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
    print(json.dumps({"kernels": entries}), flush=True)
    print(out["smi"], flush=True)
    if phases != set(ALL_PHASES.split(",")):
        print("chip_smoke: partial run, no result line", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
