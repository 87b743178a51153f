"""The port's span profiler (utils/profiling.py) against the JAX package's
(halo2_tpu/utils/profiling.py): the same nested spans and phase marks,
timed by one fake clock in both, give the same stderr lines and the same
report, character for character; the sync flag waits for the device at
every span exit and mark; `phase_marker` records into the tree under its
scope and still fills the caller's PhaseTimes; `eval_poly_batch` carries
the JAX package's span names.  On the CPU, no XLA compile.
"""

import pytest
import torch

from halo2_tpu.utils import profiling as jprof

from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.poly.arith import eval_poly_batch
from halo2_tpu_torch.utils import profiling as prof


class _Clock:
    """time.time() of a test: every call advances by the next step."""

    def __init__(self, steps):
        self.steps = list(steps)
        self.now = 100.0

    def time(self):
        self.now += self.steps.pop(0) if self.steps else 0.001
        return self.now

    perf_counter = time


@pytest.fixture
def profilers(monkeypatch):
    """Both profilers on, reset, and off and reset again after."""
    for mod in (prof, jprof):
        mod.reset()
        mod.enable(True, sync=False)
    yield
    for mod in (prof, jprof):
        mod.enable(False, sync=False)
        mod.reset()


def _scenario(mod, device_args):
    """Nested spans, a phase marker and counters, in one fixed order."""
    mark = mod.phase_marker(*device_args)
    with mod.span("outer"):
        with mod.span("inner a"):
            pass
        with mod.span("inner b"):
            with mod.span("leaf"):
                pass
        with mod.span("inner a"):
            pass
    mark("instances")
    mark("advice synth+commit")
    with mod.span("eval_batch[3x2^4]"):
        pass
    mod.incr("msm_calls", 3)
    mod.incr("ntt_calls")


def _run(mod, device_args, monkeypatch, capsys):
    steps = [0.5, 0.25, 0.125, 0.002, 0.003, 0.004, 0.0625, 0.001, 0.01,
             0.02, 0.03, 0.04, 0.05, 0.06, 0.07]
    monkeypatch.setattr(mod, "time", _Clock(steps))
    _scenario(mod, device_args)
    lines = capsys.readouterr().err
    text = mod.report(file=None)
    capsys.readouterr()
    return lines, text


def test_report_and_lines_match_jax(profilers, monkeypatch, capsys):
    j_lines, j_text = _run(jprof, (), monkeypatch, capsys)
    t_lines, t_text = _run(prof, ("cpu",), monkeypatch, capsys)
    assert t_lines == j_lines
    assert t_text == j_text
    lines = t_text.splitlines()
    assert lines[0].startswith("prover: ") and lines[0].endswith(" x0")
    assert lines[1].startswith("  instances: ")
    assert lines[3].startswith("outer: ")
    assert "  inner b: " in t_text and "    leaf: " in t_text
    assert lines[-1] == "counters: msm_calls=3, ntt_calls=1"


def test_reset_clears_the_tree_and_counters(profilers):
    with prof.span("x"):
        prof.incr("msm_calls")
    assert prof.report(file=None)
    prof.reset()
    assert prof.report(file=None) == ""
    assert prof.counters == {}


def test_disabled_records_nothing(profilers, capsys):
    prof.enable(False)
    with prof.span("x"):
        pass
    mark = prof.phase_marker("cpu")
    mark("phase")
    assert capsys.readouterr().err == ""
    assert prof.report(file=None) == ""
    phases = prof.PhaseTimes("cpu")
    assert prof.phase_marker("cpu", phases) is phases


def test_sync_waits_at_every_span_and_mark(profilers, monkeypatch):
    waits = []
    monkeypatch.setattr(prof, "_drain_device",
                        lambda device=None: waits.append(device))
    prof.enable(True, sync=True)
    with prof.span("a"):
        with prof.span("b"):
            pass
    assert len(waits) == 4                    # enter and exit of each span
    mark = prof.phase_marker("cpu", scope="keygen")
    mark("synthesize")
    assert waits[-1] == "cpu"
    prof.enable(True, sync=False)
    with prof.span("c"):
        pass
    assert len(waits) == 5


def test_phase_marker_records_under_its_scope(profilers):
    phases = prof.PhaseTimes("cpu")
    mark = prof.phase_marker("cpu", phases, scope="keygen")
    mark("synthesize")
    mark("permutation")
    assert set(phases.seconds) == {"synthesize", "permutation"}
    text = prof.report(file=None)
    lines = text.splitlines()
    assert lines[0].startswith("keygen: ") and " x0" in lines[0]
    assert lines[1].startswith("  synthesize: ") and " x1 (" in lines[1]
    assert lines[2].startswith("  permutation: ")


def test_eval_poly_batch_spans(profilers):
    F = fr("cpu")
    cols = [F.encode([1, 2, 3, 4]), F.encode([5, 6, 7, 8])]
    assert eval_poly_batch(cols, 2) == [1 + 4 + 12 + 32, 5 + 12 + 28 + 64]
    text = prof.report(file=None)
    lines = text.splitlines()
    assert lines[0].startswith("eval_batch[2x2^2]: ")
    assert lines[1].startswith("  powers: ")
    assert lines[2].startswith("  decode: ")


def test_span_sync_is_a_no_op_without_a_card(profilers):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prof.enable(True, sync=True)
    with prof.span("cpu only"):
        pass
    assert "cpu only" in prof.report(file=None)
