"""The metric arithmetic: the MSM work function, the trace's union of
intervals and idle gaps, and the per-layer readers on a synthetic trace."""

import pytest

from benchmark import harness, peaks, trace, work


def test_msm_work_function():
    # the best window for 2^20 points is 17 bits: 15 windows
    n = 1 << 20
    assert work.msm_additions(n) == min(
        -(-254 // c) * (n + (1 << c)) for c in (15, 16, 17, 18))
    assert work.msm_additions(n) == 15 * (n + (1 << 17))
    assert work.msm_mads(n) == work.msm_additions(n) * 11 * 264
    assert work.msm_additions(4 * n) < 4 * work.msm_additions(n)


def test_int_peak_derivation():
    rate = peaks.int_mad_per_s("NVIDIA H100 80GB HBM3")
    assert rate == pytest.approx(64 * 132 * 1.98e9)
    assert peaks.int_mad_per_s("cpu") is None


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {})()
        self.profiler.kineto_results.events = lambda: events


def test_trace_union_and_idle_gaps():
    events = [
        _Ev("trace:window", "CPU", 0, 1000),
        _Ev("host:witness load", "CPU", 0, 400),
        _Ev("aten::copy_", "CPU", 300, 80),
        _Ev("host:create_proof", "CPU", 400, 600),
        _Ev("aten::mul", "CPU", 750, 100),
        # two streams overlapping: 100-300 and 200-350 count as 100-350
        _Ev("msm_scan_kernel", "CUDA", 100, 200),
        _Ev("butterfly_kernel", "CUDA", 200, 150),
        _Ev("host:create_proof", "CUDA", 400, 600),   # mirrored annotation
        _Ev("Memcpy HtoD", "CUDA", 600, 100),
        _Ev("point_add_kernel", "CUDA", 900, 200),   # clipped at 1000
    ]
    r = trace.reduce(_Prof(events))
    assert r["busy_s"] == pytest.approx((250 + 100 + 100) * 1e-9)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert r["launches"] == 3
    # gaps 0-100 (mid 50: the load's Python), 350-600 (mid 475: the
    # prover's Python) and 700-900 (mid 800: inside aten::mul)
    assert r["idle_by_host_op"] == pytest.approx({
        "witness load, no torch op": 100e-9,
        "create_proof, no torch op": 250e-9, "aten::mul": 200e-9})
    r["proofs"] = 1
    ctx = {"trace": r, "proofs": 2, "counters": {"msm_calls": 10,
           "msm_points": 10 << 20}, "device_kind": "NVIDIA H100 80GB HBM3"}
    idle = harness.metric_reader("device.idle_share")(ctx)
    assert idle == pytest.approx(100 * (1 - 450 / 1000))
    assert harness.metric_reader("device.launches")(ctx) == 3
    msm_ms = harness.metric_reader("poly.msm_device_ms")(ctx)
    assert msm_ms == pytest.approx((200 + 100) * 1e-6)
    ntt_ms = harness.metric_reader("poly.ntt_device_ms")(ctx)
    assert ntt_ms == pytest.approx(150e-6)
    share = harness.metric_reader("kernels.msm_roofline")(ctx)
    least = 5 * work.msm_mads(1 << 20) / peaks.int_mad_per_s(
        "NVIDIA H100 80GB HBM3")
    assert share == pytest.approx(100 * least / (msm_ms / 1e3))


def test_host_op_is_the_innermost_running():
    host = [("outer", 0, 100), ("a", 10, 20), ("b", 30, 90), ("c", 40, 50)]
    assert trace.host_op_at(host, [5, 15, 35, 45, 60, 95, 120]) == [
        "outer", "a", "b", "c", "b", "outer", None]


def test_phase_readers_are_means_per_proof():
    ctx = {"proofs": 9, "phase_proofs": 4, "phase_s": {"evaluate_h": 2.0, "multiopen": 1.0,
                                    "grand products/sums": 0.4,
                                    "lookup compress+m": 0.4},
           "phase_peak": {"evaluate_h": 3e9}, "witness_load_s": 0.8,
           "setup": {"keygen_s": 5.0, "witness_s": 2.0}}
    read = harness.metric_reader
    assert read("evaluator.evaluate_h_s")(ctx) == 0.5
    assert read("multiopen.s")(ctx) == 0.25
    assert read("args.phase_s")(ctx) == pytest.approx(0.2)
    assert read("evaluator.peak_gb")(ctx) == 3.0
    assert read("files.witness_load_s")(ctx) == 0.2
    assert read("setup.keygen_s")(ctx) == 5.0
    assert read("setup.witness_s")(ctx) == 2.0
