"""The harness finds every piece of a cell by name, so a new cell,
configuration or metric is new files and entries only."""

import importlib
import json
import os

import pytest

from benchmark import harness, traffic

ROOT = harness.ROOT
BENCH = harness.load_benchmark()


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_pieces_found_by_name(cell):
    entry, config = harness.find_cell(BENCH, cell)
    mix = traffic.load(entry["traffic"])
    assert {"k", "instances", "opening"} <= set(mix)
    assert os.path.exists(os.path.join(ROOT, config["file"]))
    program = importlib.import_module(f"benchmark.circuits.{config['name']}")
    spec = importlib.import_module(f"benchmark.reference.{config['name']}")
    assert callable(program.circuit) and callable(spec.columns)
    assert os.path.exists(spec.CS_FILE)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = harness.metric_reader(metric)
    empty = {"k": 4, "instances": 1, "proofs": 0, "phase_proofs": 0,
             "phase_s": {},
             "phase_peak": {}, "counters": {}, "setup": {},
             "witness_load_s": 0.0, "trace": None, "device_kind": "cpu"}
    assert read(empty) is None


def test_new_cell_needs_no_edit(tmp_path):
    (tmp_path / "k5.gwc.json").write_text(json.dumps(
        {"k": 5, "instances": 3, "opening": "shplonk",
         "offload_lagrange": False}))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "new.cell", "config": "standard_plonk", "traffic": "k5.gwc",
         "chips": 1, "why": "test"}])
    entry, config = harness.find_cell(bench, "new.cell")
    plan = traffic.Plan(traffic.load(entry["traffic"], str(tmp_path)), 7)
    assert (plan.k, plan.instances, plan.gwc) == (5, 3, False)
    assert config["name"] == "standard_plonk"


def test_contract_shape():
    """Keys, names and the limits BENCHMARK.json is held to."""
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert {"proof_s", "peak_mem_gb", "setup_s"} <= ends
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends
        assert set(m["workloads"]) <= {c["name"] for c in BENCH["workloads"]}
    for c in BENCH["workloads"]:
        assert c["chips"] == 1 and len(c["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_seeds_repeat_and_differ():
    mix = traffic.load("k18.x4.shplonk")
    a, b = traffic.Plan(mix, 2**31 + 5), traffic.Plan(mix, 2**31 + 5)
    assert a.witness_seeds == b.witness_seeds
    assert len(set(a.witness_seeds)) == 4
    assert a.prover_seed(3) == b.prover_seed(3) != a.prover_seed(4)
