"""One run of one cell: set-up, a measured window of proofs from stored
witnesses, and the comparison with the plain reference.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration's program side in benchmark/circuits/<config>.py and plain
reference in benchmark/reference/<config>.py, its traffic in
benchmark/workloads/<traffic>.json, and each per-layer metric's reader in
benchmark/metrics/<metric>.py.  Adding a cell, a configuration or a metric
adds files and entries and edits none."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time

import torch
from halo2_tpu_torch.utils.profiling import PhaseTimes

from benchmark import traffic
from benchmark.reference import check

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "halo2_tpu"}
# proofs of a --trace 1 window that run under torch.profiler, as the
# timed window runs them; the later ones run under PhaseTimes
TRACE_PROOFS = 2


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    cells = [c for c in bench["workloads"] if c["name"] == name]
    if not cells:
        raise KeyError(f"no workload named {name!r}")
    config = [c for c in bench["configs"] if c["name"] == cells[0]["config"]]
    return cells[0], config[0]


def metric_reader(name: str):
    """read(ctx) of benchmark/metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _merge(into: dict, pt, peaks: dict):
    for name, s in pt.seconds.items():
        into[name] = into.get(name, 0.0) + s
    for name, p in pt.peaks.items():
        peaks[name] = max(peaks.get(name, 0), p["allocated"])


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", bench: dict | None = None,
        workloads_dir: str | None = None,
        workers: int | None = None) -> tuple[dict, list]:
    """(result line, [(number, value, limit)]) of one run."""
    # looked up at each run, so that a test can put a broken prover in
    from halo2_tpu_torch.io import serialization
    from halo2_tpu_torch.plonk import prover
    from halo2_tpu_torch.plonk.keygen import keygen
    from halo2_tpu_torch.poly.commitment import Params
    from halo2_tpu_torch.utils import profiling

    bench = bench or load_benchmark()
    cell, config = find_cell(bench, workload)
    plan = traffic.Plan(traffic.load(cell["traffic"], workloads_dir), seed)
    k = plan.k
    program = importlib.import_module(f"benchmark.circuits.{config['name']}")
    spec = importlib.import_module(f"benchmark.reference.{config['name']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    setup = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        sync()
        setup[name] = time.perf_counter() - t
        return out

    if cuda:
        from halo2_tpu_torch.utils import build
        timed("build_s", build.build_all)
    params = timed("unsafe_setup_s", lambda: Params.unsafe_setup(
        k, seed=plan.setup_seed, device=dev))
    planner = program.FLOOR_PLANNER
    vk, pk = timed("keygen_s", lambda: keygen(
        params, program.circuit(k), floor_planner=planner, device=dev))
    inputs = [spec.make_witness(s) for s in plan.witness_seeds]
    instances = [program.instances(k, w) for w in inputs]
    tmp = tempfile.TemporaryDirectory(prefix="witness-")
    paths = [os.path.join(tmp.name, f"w{i}.bin") for i in range(len(inputs))]

    def write_witnesses():
        for w, inst, path in zip(inputs, instances, paths):
            prover.create_witness(pk, program.circuit(k, w), inst, path,
                                  floor_planner=planner)
    timed("witness_s", write_witnesses)

    loads = {"s": 0.0}

    def annotate(name):
        return (torch.profiler.record_function(name) if profiled
                else contextlib.nullcontext())

    def prove(prover_seed, phases=None):
        t = time.perf_counter()
        with annotate("host:witness load"):
            advice = [serialization.load_witness(p, dev) for p in paths]
        if phases is not None:
            sync()
            loads["s"] += time.perf_counter() - t
        with annotate("host:create_proof"):
            return prover.create_proof_multi(
                params, pk, [None] * len(paths), instances,
                seed=prover_seed, use_gwc=plan.gwc, device=dev,
                phases=phases, witness_advice=advice,
                offload_lagrange=plan.offload)

    profiled = False
    timed("warmup_s", lambda: prove(plan.warmup_seed))
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the window: a closed loop of proofs until `seconds` have passed.  With
    # --trace 1 the first TRACE_PROOFS run under torch.profiler without
    # phase marks (the device's schedule is the timed window's), and the
    # rest under PhaseTimes(peaks=True), whose marks wait for the device
    profiling.reset()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    phase_s, phase_peak, phase_proofs = {}, {}, 0
    proofs, reduced = [], None
    t0 = time.perf_counter()
    while True:
        i = len(proofs)
        seed_i = plan.prover_seed(i)
        profiled = trace and i < TRACE_PROOFS
        if profiled and i == 0:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            window_rf = torch.profiler.record_function("trace:window")
            window_rf.__enter__()
        pt = PhaseTimes(dev, peaks=True) if trace and not profiled else None
        proofs.append((seed_i, prove(seed_i, pt)))
        sync()
        if pt is not None:
            _merge(phase_s, pt, phase_peak)
            phase_proofs += 1
        if profiled and i + 1 == TRACE_PROOFS:
            window_rf.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            from benchmark import trace as trace_mod
            reduced = trace_mod.reduce(prof)
            reduced["proofs"] = TRACE_PROOFS
            del prof
        if (time.perf_counter() - t0 >= seconds
                and (not trace or phase_proofs)):
            break
    window_s = time.perf_counter() - t0
    counters = dict(profiling.counters)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace:
        window_peak = max([window_peak] + list(phase_peak.values()))

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": max(setup_peak, window_peak)}
    vk_fixed = list(vk.fixed_commitments)
    vk_sigmas = list(vk.permutation.commitments)
    # the program's state goes before the reference runs
    del params, vk, pk
    if cuda:
        torch.cuda.empty_cache()
    tmp.cleanup()

    ref = check.Reference(config["name"], k, plan.setup_seed, inputs,
                          workers=workers)
    judged = check.judge(ref, vk_fixed, vk_sigmas, proofs, plan.gwc)
    compared = [(name, judged[name], limit)
                for name, limit in check.LIMITS.items()]
    correct = (judged["proofs_checked"] > 0
               and all(v <= lim for _, v, lim in compared))

    metrics = {}
    if not trace:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        values = {"proof_s": window_s / len(proofs),
                  "peak_mem_gb": window_peak / 1e9,
                  "setup_s": setup_s}
        for name, value in values.items():
            if name in units:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        ctx = {"k": k, "instances": plan.instances, "proofs": len(proofs),
               "phase_proofs": phase_proofs, "phase_s": phase_s, "phase_peak": phase_peak,
               "counters": counters, "setup": setup,
               "witness_load_s": loads["s"], "trace": reduced,
               "device_kind": device_info["kind"]}
        for m in bench["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_phases = {n: v / phase_proofs for n, v in phase_s.items()}
        if reduced is not None:
            device_info["busy_s"] = reduced["busy_s"]
            device_info["window_s"] = reduced["window_s"]

    result = {"correct": correct, "attempted": len(proofs),
              "failed": judged["proofs_rejected"], "metrics": metrics,
              "device": device_info}
    if reduced is not None:
        ops = sorted(reduced["kernels"].items(), key=lambda x: -x[1])[:10]
        gaps = sorted(reduced["idle_by_host_op"].items(),
                      key=lambda x: -x[1])[:10]
        result["breakdown"] = {"device_ops": [list(x) for x in ops],
                               "idle_gaps": [list(x) for x in gaps]}
    result["setup_split_s"] = setup
    if trace:
        result["phase_s_per_proof"] = result_phases
    result["proofs_checked"] = judged["proofs_checked"]
    if judged["reasons"]:
        result["rejections"] = judged["reasons"][:5]
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}
    return result, compared
