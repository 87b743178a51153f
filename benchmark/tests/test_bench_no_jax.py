"""Nothing the benchmark runs loads JAX or the JAX package: the top-level
name of every loaded module is compared whole (the port's name begins with
the JAX package's)."""

import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("halo2_tpu_torch", "halo2_tpu_torch.plonk", "jax_like",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in harness.forbidden_modules()
                if m in ("halo2_tpu_torch", "halo2_tpu_torch.plonk",
                         "jax_like", "flaxen")]
    monkeypatch.setitem(sys.modules, "halo2_tpu.plonk", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"halo2_tpu.plonk", "jaxlib"} <= set(harness.forbidden_modules())


def test_a_cpu_run_loads_no_jax():
    """A whole run of a small cell in a fresh process, then its modules."""
    code = (
        "import sys, time\n"
        f"sys.path[0] = {ROOT!r}\n"
        f"sys.path.insert(1, {os.path.dirname(__file__)!r})\n"
        "import helpers\n"
        "from benchmark import harness, control\n"
        "import benchmark.run, benchmark.trace, torch.profiler\n"
        "for m in [m['name'] for m in helpers.bench()['per_layer']]:\n"
        "    harness.metric_reader(m)\n"
        "result, _ = helpers.run('t.plonk.k4', 9)\n"
        "assert result['correct'], result\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=3600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
