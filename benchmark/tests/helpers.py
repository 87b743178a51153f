"""A BENCHMARK.json with the test cells added, and one CPU run of a cell."""

import os
import time

from benchmark import harness

WORKLOADS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "workloads")
CELLS = {"t.plonk.k4": ("standard_plonk", "k4.gwc"),
         "t.plonk.k4.x2": ("standard_plonk", "k4.x2.shplonk")}


def bench() -> dict:
    b = harness.load_benchmark()
    for name, (config, mix) in CELLS.items():
        b["workloads"].append({"name": name, "config": config,
                               "traffic": mix, "chips": 1, "why": "test"})
        for m in b["per_layer"]:
            m["workloads"].append(name)
    return b


def run(cell: str, seed: int, trace: bool = False):
    return harness.run(cell, seed, 0.01, trace, time.perf_counter(),
                       device="cpu", bench=bench(), workloads_dir=WORKLOADS,
                       workers=1)
