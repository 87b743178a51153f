#!/usr/bin/env python3
"""Smoke run of halo2_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--k K] [--phases env,kernels,golden,prove,dft]

Builds the CUDA kernels from halo2_tpu_torch/csrc, then:

  kernels  holds every kernel against its plain PyTorch version on the card
           (exact equality of the limb words: the tolerance is zero), at the
           shapes the k-row proof gives it and at ragged ones, and times it
           with CUDA events beside its bound;
  golden   proves tests/data/torch_golden_proof.json's circuit (K = 4) with
           its seeds and compares the proof bytes;
  prove    unsafe_setup -> keygen -> create_proof -> verify_proof for a
           row-filling chain of mul gates at 2^k rows, with every kernel's
           launch count set to 0 just before and read just after; a proof
           with one byte flipped must be rejected;
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
import json
import os
import subprocess
import sys
import time

import torch

from halo2_tpu_torch.circuits import MulChainCircuit, SimpleCircuit
from halo2_tpu_torch.curves import cuda_point, g1
from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields.bn254 import fq, fr
from halo2_tpu_torch.fields.limbs import N_LIMBS, limbs_to_ints
from halo2_tpu_torch.msm import sorted as msm_sorted
from halo2_tpu_torch.msm.msm import SORT_BLOCK
from halo2_tpu_torch.ntt import dft_matmul as dm
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.utils import build, profiling
from halo2_tpu_torch.utils.profiling import bound_ms as _bound
from halo2_tpu_torch.utils.profiling import max_abs_err as _max_err
from halo2_tpu_torch.utils.profiling import time_cuda as _time_cuda

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_proof.json")
DFT_PROBE = os.path.join(ROOT, "examples", "torch_mxu_dft_probe.py")

# 32-bit integer operations of one field operation, as the kernels do it:
# a CIOS Montgomery product is 8 rows of (8 a*b_i + 8 m*p) multiply-adds
# plus the 8 products for m; an add or sub is two 8-word carry chains.
OPS_MUL = 2 * (2 * 8 * 8 + 8)
OPS_ADD = 16
# field products / additions of the point formulas (curves/formulas.py)
POINT_OPS = {"add": (12, 29), "add_mixed": (11, 25), "double": (8, 17)}
WORD = 4


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
    regs = {}
    for name, log in built["logs"].items():
        fn = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif "Used" in line and "registers" in line and fn:
                regs[fn] = line.split("Used", 1)[1].strip()
                fn = None
    out["smi"] = smi.stdout.strip().splitlines()[0]
    env = {"nvidia_smi": out["smi"], "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "nvcc": nvcc.stdout.strip().splitlines()[-2:],
           "build_seconds": round(built["seconds"], 2), "ptxas": regs}
    print(json.dumps({"env": env}), flush=True)


def _shapes(k: int):
    """The shapes the k-row proof of MulChainCircuit gives each kernel."""
    cs = ConstraintSystem()
    MulChainCircuit(1).configure(cs)
    cs_degree = cs.degree()
    dom_k = k
    qd = max(cs_degree - 1, 1)
    ext_k = dom_k
    while (1 << ext_k) < (1 << dom_k) * qd:
        ext_k += 1
    n, ext_n = 1 << k, 1 << ext_k
    block = min(SORT_BLOCK, n)
    windows = msm_sorted.num_windows_for(254)
    return {"n": n, "ext_n": ext_n, "ext_k": ext_k,
            "scan": windows * block}


def phase_kernels(k: int, device) -> list:
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    sh = _shapes(k)
    entries = []

    # ---- K1: elementwise add / sub / mul, Fr and Fq --------------------
    variants = []
    for F in (fr(device), fq(device)):
        for op in ("add", "sub", "mul"):
            worst = 0
            for n in (sh["ext_n"], 1000, 1):
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
            n = sh["ext_n"]
            a, b = _rand_field(F, (n,), gen), _rand_field(F, (n,), gen)
            ms = _time_cuda(lambda: cuda_ops.binop(op, F, a, b), 20)
            plain_ms = _time_cuda(
                lambda: cuda_ops.plain_binop(op, F, a, b), 2)
            bound_ms, by = _bound(3 * N_LIMBS * WORD * n,
                                  (OPS_MUL if op == "mul" else OPS_ADD) * n)
            variants.append({"variant": f"{op}/{F.name}", "n": n,
                             "max_abs_err": worst, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": by})
    head = next(v for v in variants if v["variant"] == "mul/Fr")
    entries.append({
        "name": "field_binop", "route": "cuda",
        "source": "halo2_tpu_torch/csrc/field_kernels.cu",
        "replaces": "halo2_tpu/fields/pallas_ops.py:65",
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape": f"mul/Fr (16, {head['n']})",
        "variants": variants})

    # ---- K2: butterfly --------------------------------------------------
    F = fr(device)
    worst = 0
    n1 = 1 << ((sh["ext_k"] + 1) // 2)
    cols = 3
    cases = [(cols, sh["ext_n"] // 2, n1), (5, 24, 4), (7, 1, 1), (1, 1000, 8)]
    for mid, half, rep in cases:
        x = _rand_field(F, (mid, 2, half), gen)
        tw = _rand_field(F, (half // rep,), gen)
        lo, hi = x[:, :, 0, :], x[:, :, 1, :]
        worst = max(worst, _max_err(cuda_ops.butterfly(F, lo, hi, tw, rep),
                                    cuda_ops.plain_butterfly(F, lo, hi, tw,
                                                             rep)))
    mid, half, rep = cases[0]
    x = _rand_field(F, (mid, 2, half), gen)
    tw = _rand_field(F, (half // rep,), gen)
    lo, hi = x[:, :, 0, :], x[:, :, 1, :]
    n = mid * half
    ms = _time_cuda(lambda: cuda_ops.butterfly(F, lo, hi, tw, rep), 20)
    plain_ms = _time_cuda(
        lambda: cuda_ops.plain_butterfly(F, lo, hi, tw, rep), 2)
    bound_ms, by = _bound((4 * n + half // rep) * N_LIMBS * WORD,
                          (OPS_MUL + 2 * OPS_ADD) * n)
    entries.append({
        "name": "ntt_butterfly", "route": "cuda",
        "source": "halo2_tpu_torch/csrc/field_kernels.cu",
        "replaces": "halo2_tpu/fields/pallas_ops.py:115",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
        "shape": f"lo, hi (16, {mid}, {half}), tw (16, {half // rep})"})

    # ---- K3: shared-table product -----------------------------------------
    worst = 0
    cases = [(cols, sh["ext_n"]), (sh["ext_n"] // 4, 4), (7, 1000), (1, 1)]
    for mid, kk in cases:
        a = _rand_field(F, (mid, kk), gen)
        t = _rand_field(F, (kk,), gen)
        worst = max(worst, _max_err(cuda_ops.mul_tiled(F, a, t),
                                    cuda_ops.plain_mul_tiled(F, a, t)))
    mid, kk = cases[0]
    a, t = _rand_field(F, (mid, kk), gen), _rand_field(F, (kk,), gen)
    n = mid * kk
    ms = _time_cuda(lambda: cuda_ops.mul_tiled(F, a, t), 20)
    plain_ms = _time_cuda(lambda: cuda_ops.plain_mul_tiled(F, a, t), 2)
    bound_ms, by = _bound((2 * n + kk) * N_LIMBS * WORD, OPS_MUL * n)
    entries.append({
        "name": "mul_tiled", "route": "cuda",
        "source": "halo2_tpu_torch/csrc/field_kernels.cu",
        "replaces": "halo2_tpu/fields/pallas_ops.py:149",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
        "shape": f"a (16, {mid}, {kk}), t (16, {kk})"})

    # ---- K4: point add / add_mixed / double ----------------------------
    n = sh["n"]
    aff_p, proj_p = _rand_points(n, gen, device)
    aff_q, proj_q = _rand_points(n, gen, device)
    ident = g1.identity((n,), device)
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
        ms = _time_cuda(lambda: cuda_point.point_op(op, coords), 20)
        plain_ms = _time_cuda(
            lambda: cuda_point.plain_point_op(op, coords), 2)
        muls, adds = POINT_OPS[op]
        bound_ms, by = _bound((len(coords) + 3) * N_LIMBS * WORD * n,
                              (muls * OPS_MUL + adds * OPS_ADD) * n)
        variants.append({"variant": op, "n": n, "max_abs_err": worst,
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": by})
    head = variants[0]
    entries.append({
        "name": "point_op", "route": "cuda",
        "source": "halo2_tpu_torch/csrc/point_kernels.cu",
        "replaces": "halo2_tpu/curves/pallas_point.py:38",
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape": f"add, 6 x (16, {n})",
        "variants": variants})

    # ---- K5: packed mixed add (the MSM scan step) -----------------------
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
    ms = _time_cuda(lambda: cuda_point.add_mixed_packed(c, packed, sign), 20)
    plain_ms = _time_cuda(
        lambda: cuda_point.plain_add_mixed_packed(c, packed, sign), 2)
    muls, adds = POINT_OPS["add_mixed"]
    m = sh["scan"]
    bound_ms, by = _bound((7 * N_LIMBS + 1) * WORD * m,
                          (muls * OPS_MUL + (adds + 1) * OPS_ADD) * m)
    entries.append({
        "name": "add_mixed_packed", "route": "cuda",
        "source": "halo2_tpu_torch/csrc/point_kernels.cu",
        "replaces": "halo2_tpu/curves/pallas_point.py:73",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
        "shape": f"carry 3 x (16, {m}), packed (16, {m}), sign ({m},)"})

    for e in entries:
        if e["max_abs_err"] != 0:
            raise AssertionError(
                f"kernel {e['name']} disagrees with its plain version: "
                f"max abs err {e['max_abs_err']}")
    return entries


def phase_golden(device):
    with open(GOLDEN) as fh:
        golden = json.load(fh)
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
    print(json.dumps({"golden": {
        "k": golden["k"], "seeds": sorted(golden["proofs"]),
        "bytes_equal": True, "verified": True,
        "seconds": round(time.time() - t0, 2)}}), flush=True)


def _reset_counts():
    for counts in (cuda_ops.launch_counts, cuda_point.launch_counts,
                   dm.launch_counts):
        for key in counts:
            counts[key] = 0


def phase_prove(k: int, seed: int, device) -> dict:
    circuit = MulChainCircuit(MulChainCircuit.steps_for(k), a=3, b=5)
    out = circuit.expected_out()
    torch.cuda.reset_peak_memory_stats(device)
    profiling.reset()
    _reset_counts()                          # the main path starts here
    phases = profiling.PhaseTimes(device)
    params = Params.unsafe_setup(k, seed=seed, device=device)
    phases("unsafe_setup")
    vk, pk = keygen(params, circuit, device=device)
    phases("keygen")
    prover_phases = profiling.PhaseTimes(device)
    proof = create_proof(params, pk, circuit, [[out]], seed=seed + 1,
                         device=device, phases=prover_phases)
    phases("create_proof")
    launches = {**cuda_ops.launch_counts, **cuda_point.launch_counts}
    launches = dict(launches)                # the main path ends here
    pv = params.verifier(1)
    ok = verify_proof(pv, vk, [[out]], proof)
    phases("verify_proof")
    tampered = bytearray(proof)
    tampered[-40] ^= 1
    try:
        bad = verify_proof(pv, vk, [[out]], bytes(tampered))
    except ValueError:
        bad = False
    if not ok:
        raise AssertionError("the proof was rejected")
    if bad:
        raise AssertionError("a tampered proof was accepted")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 f"main path")
    n = 1 << k
    usable = vk.cs.usable_rows(n)
    print(json.dumps({"prove": {
        "k": k, "rows": n, "rows_assigned": 2 * circuit.steps,
        "fill_of_usable": round(2 * circuit.steps / usable, 4),
        "degree": vk.cs.degree(), "extended_k": vk.domain.extended_k,
        "proof_bytes": len(proof), "verified": ok,
        "tampered_rejected": not bad,
        "seconds": {n_: round(s, 3) for n_, s in phases.seconds.items()},
        "create_proof_seconds": {n_: round(s, 3) for n_, s
                                 in prover_phases.seconds.items()},
        "launches": launches, "counters": dict(profiling.counters),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device)}}),
        flush=True)
    return launches


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
        "max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "products_ms": head["products_ms"],
        "shape": f"lo, hi ({DFT_SIZES[0] * dm.NB}, {DFT_B}) float32 -> "
                 f"(17, {DFT_SIZES[0]}, {DFT_B})",
        "launches_from": "the dft phase (dft_matmul at m = 16 and 64); the "
                         "prove path launches it 0 times",
        "variants": [variant(m) for m in DFT_SIZES]}
    return entry, launches


LAUNCH_KEY = {"field_binop": "binop", "ntt_butterfly": "butterfly",
              "mul_tiled": "mul_tiled", "point_op": "point_op",
              "add_mixed_packed": "add_mixed_packed",
              "dft_epilogue": "dft_epilogue"}
ALL_PHASES = "env,kernels,golden,prove,dft"


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
    entries = phase_kernels(args.k, device) if "kernels" in phases else []
    if "golden" in phases:
        phase_golden(device)
    launches = phase_prove(args.k, args.seed, device) \
        if "prove" in phases else {}
    if "dft" in phases:
        entry, dft_launches = phase_dft(device, out["smi"])
        entries.append(entry)
        launches.update(dft_launches)
    for e in entries:
        e["launches"] = launches.get(LAUNCH_KEY[e["name"]], 0)
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
