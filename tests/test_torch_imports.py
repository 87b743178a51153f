"""The port stands alone: no module of halo2_tpu_torch, nor chip_smoke.py,
nor the port's examples, imports jax or anything of halo2_tpu; and the entry points raise — they do
not carry on on the CPU — when no device is passed and there is no card.
"""

import inspect
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import halo2_tpu_torch
from halo2_tpu_torch.circuits import SimpleCircuit
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.io import load_params, load_witness, save_witness
from halo2_tpu_torch.plonk.prover import (create_proof, create_proof_multi,
                                          create_proof_from_witness)
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.utils.device import require_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = sorted(
    m.name for m in pkgutil.walk_packages(halo2_tpu_torch.__path__,
                                          "halo2_tpu_torch."))
# scripts beside the package, imported by name from the repo's root
SCRIPTS = ["chip_smoke", "examples.torch_mxu_dft_probe",
           "examples.torch_profile_prove", "examples.torch_msm_memory",
           "examples.torch_two_chip_example",
           "examples.torch_lookup_shuffle_example",
           "examples.torch_circuit_layout", "examples.torch_cost_model",
           "examples.torch_fork_cost", "examples.torch_warm_proofs",
           "examples.torch_kernel_audit", "examples.torch_launch_cost",
           "examples.torch_probe_k22", "examples.torch_bench_prover",
           "examples.torch_bench_keygen", "examples.torch_chain_probe",
           "examples.torch_setup_probe", "examples.torch_simple_example",
           "examples.torch_range_check_example",
           "examples.torch_profile_msm", "examples.torch_bucket_probe"]

_BLOCKED_IMPORT = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["halo2_tpu"] = None
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = [m for m in sys.modules
          if m == "jax" or m.startswith("jax.") or m == "jaxlib"
          or m == "halo2_tpu" or m.startswith("halo2_tpu.")]
leaked = [m for m in leaked if sys.modules[m] is not None]
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
"""


def test_package_has_its_modules():
    for name in ("halo2_tpu_torch.fields.cuda_ops",
                 "halo2_tpu_torch.curves.cuda_point",
                 "halo2_tpu_torch.ntt.ntt", "halo2_tpu_torch.ntt.dft_matmul",
                 "halo2_tpu_torch.msm.sorted",
                 "halo2_tpu_torch.plonk.prover",
                 "halo2_tpu_torch.plonk.logup_prover",
                 "halo2_tpu_torch.plonk.shuffle_prover",
                 "halo2_tpu_torch.plonk.range_check",
                 "halo2_tpu_torch.plonk.verifier",
                 "halo2_tpu_torch.multiopen.shplonk",
                 "halo2_tpu_torch.io.cs_format",
                 "halo2_tpu_torch.io.serialization",
                 "halo2_tpu_torch.convert",
                 "halo2_tpu_torch.native",
                 "halo2_tpu_torch.plonk.parallel_synthesis",
                 "halo2_tpu_torch.dev", "halo2_tpu_torch.dev.mock",
                 "halo2_tpu_torch.dev.cost", "halo2_tpu_torch.dev.gates",
                 "halo2_tpu_torch.dev.graph",
                 "halo2_tpu_torch.utils.offload"):
        assert name in MODULES


def test_package_has_its_names():
    """The JAX package's surface that the port carries: the MSM's bucket
    path and its API, the span profiler, the sanity checks' switches and
    the G2 line cache."""
    from halo2_tpu_torch.curves import cuda_point
    from halo2_tpu_torch.msm import msm
    from halo2_tpu_torch.pairing import bn254
    from halo2_tpu_torch.plonk import logup_prover, permutation
    from halo2_tpu_torch.plonk import shuffle_prover
    from halo2_tpu_torch.utils import profiling
    for mod, names in (
            (cuda_point, ("msm_bucket", "plain_msm_bucket", "BUCKETS")),
            (msm, ("msm", "msm_many", "msm_host_result", "C_BITS",
                   "_digits", "_pick_lanes", "SORT_BLOCK")),
            (profiling, ("span", "enable", "report", "reset",
                         "phase_marker", "_Node")),
            (bn254, ("prepare_g2", "_disk_path", "_steps_to_wire",
                     "_steps_from_wire", "_G2_CACHE_DIR")),
            (permutation, ("_SANITY",)), (logup_prover, ("_SANITY",)),
            (shuffle_prover, ("_SANITY",))):
        for name in names:
            assert hasattr(mod, name), (mod.__name__, name)
    assert cuda_point.launch_counts["msm_bucket"] >= 0
    params = inspect.signature(msm.msm).parameters
    assert list(params) == ["points", "scalars_mont", "max_bits", "lanes",
                            "force_scatter"]


def test_every_module_imports_without_jax_or_halo2_tpu():
    """All modules of the package, chip_smoke and the port's examples, in
    one subprocess where importing jax or halo2_tpu raises."""
    done = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, *MODULES, *SCRIPTS],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert f"imported {len(MODULES) + len(SCRIPTS)}" in done.stdout


def test_sources_do_not_name_jax():
    base = os.path.join(ROOT, "halo2_tpu_torch")
    paths = [os.path.join(ROOT, s.replace(".", os.sep) + ".py")
             for s in SCRIPTS]
    for dirpath, dirs, files in os.walk(base):
        if "_build" in dirs:
            dirs.remove("_build")           # build outputs, not sources
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            text = fh.read()
        assert "import jax" not in text, path
        assert "from halo2_tpu." not in text, path
        assert "import halo2_tpu\n" not in text, path


def test_every_port_example_is_checked():
    """Each examples/torch_*.py is among SCRIPTS, so the two checks above
    cover every script of the port beside the package."""
    found = sorted("examples." + f[:-3]
                   for f in os.listdir(os.path.join(ROOT, "examples"))
                   if f.startswith("torch_") and f.endswith(".py"))
    assert [m for m in found if m not in SCRIPTS] == []


# the modules of the large-domain path: their thresholds and switches are
# module constants and keywords, never the environment
LARGE_PATH_MODULES = ("ntt/ntt.py", "poly/domain.py", "poly/commitment.py",
                      "plonk/keygen.py", "plonk/prover.py",
                      "plonk/vanishing.py", "utils/offload.py")


def test_large_path_reads_no_environment():
    for rel in LARGE_PATH_MODULES:
        with open(os.path.join(ROOT, "halo2_tpu_torch", rel)) as fh:
            text = fh.read()
        assert "environ" not in text and "getenv" not in text, rel


_IMPORT_BUILDS_NOTHING = """
import subprocess, sys
def refuse(*args, **kwargs):
    raise AssertionError(f"a build at import: {args[:1]}")
subprocess.run = subprocess.Popen = subprocess.check_call = refuse
import halo2_tpu_torch.native as native
for name in sys.argv[1:]:
    __import__(name)
assert native._lib is None
print("nothing built")
"""


def test_importing_the_codec_builds_nothing():
    """The host codec is built at its first use, never at import: with
    every way to start a compiler refused, the package imports and the
    codec's extension stays unloaded."""
    done = subprocess.run(
        [sys.executable, "-c", _IMPORT_BUILDS_NOTHING, *MODULES], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "nothing built" in done.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")


def test_require_device():
    assert require_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        require_device("meta")
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        require_device()


def test_unsafe_setup_raises_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        Params.unsafe_setup(2, seed=1)


def test_keygen_and_create_proof_raise_without_a_card():
    _no_card()
    params = Params.unsafe_setup(2, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        keygen(params, SimpleCircuit())
    with pytest.raises(RuntimeError, match="CUDA"):
        create_proof(params, None, SimpleCircuit(3, 5), [[0]], seed=0)


def test_multi_prover_and_file_loaders_raise_without_a_card(tmp_path):
    _no_card()
    params = Params.unsafe_setup(2, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_proof_multi(params, None, [SimpleCircuit(3, 5)], [[[0]]],
                           seed=0)
    path = str(tmp_path / "params.bin")
    with open(path, "wb") as fh:
        params.write(fh)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_params(path)
    wpath = str(tmp_path / "witness.bin")
    save_witness([[1, 2, 3, 4]], wpath)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_witness(wpath)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_proof_from_witness(params, None, [[0]], wpath, seed=0)


def test_chip_smoke_exits_nonzero_and_prints_no_result_without_a_card():
    _no_card()
    done = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
