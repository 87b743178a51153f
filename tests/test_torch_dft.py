"""The port's tensor-core DFT (halo2_tpu_torch/ntt/dft_matmul.py, the
module of kernel K6) against the JAX package's examples/mxu_dft_probe.py,
on the CPU.

The same inputs, made from a seed with numpy (values below p, with 0, 1
and p - 1 among them), go through the JAX probe's `dft_matmul` and through
the port with CPU tensors (the epilogue's plain version).  Tolerance: none
— matrices, limb words and decoded integers are compared for equality, and
every output is held against an O(m^2) host big-int DFT mod p.  The JAX
side runs once per module, at m = 16 and 64 with B = 8.

The JAX probe is not a package module: it is loaded from its file.  Its
import points JAX's persistent compilation cache at another directory;
the fixture puts the settings back as tests/conftest.py made them, so the
rest of the worker's JAX tests keep their warm cache.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu_torch.fields.limbs import ints_to_limbs_np, limbs_to_ints
from halo2_tpu_torch.ntt import dft_matmul as dm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (16, 64)
B = 8
_CACHE_SETTINGS = ("jax_compilation_cache_dir",
                   "jax_persistent_cache_min_compile_time_secs")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(m: int):
    """(16, m, B) uint32 limbs of values below p, and the values as ints
    (column b is one transform)."""
    rs = np.random.RandomState(1000 + m)
    cols = [[int.from_bytes(rs.bytes(32), "little") % dm.P
             for _ in range(m)] for _ in range(B)]
    cols[0][:3] = [0, 1, dm.P - 1]
    return np.stack([ints_to_limbs_np(c) for c in cols], axis=2), cols


@pytest.fixture(scope="module")
def jax_side():
    before = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    try:
        probe = _load("mxu_dft_probe",
                      os.path.join(ROOT, "examples", "mxu_dft_probe.py"))
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    out = {"before": before, "probe": probe,
           "fold": np.array(probe.fold_table())}
    for m in SIZES:
        x, _ = _inputs(m)
        M_lo, M_hi, w = probe.dft_matrices(m)
        y = jax.jit(lambda a: probe.dft_matmul(a, M_lo, M_hi, m))(
            jnp.asarray(x))
        out[m] = {"M_lo": np.asarray(M_lo, np.float32),
                  "M_hi": np.asarray(M_hi, np.float32), "w": w,
                  "out": np.asarray(y),
                  "bytes": np.asarray(probe.bytes_from_limbs(jnp.asarray(x)))}
    return out


@pytest.fixture(scope="module")
def port_side():
    out = {}
    for m in SIZES:
        x, _ = _inputs(m)
        mats = dm.dft_matrices(m, "cpu")
        out[m] = {"mats": mats, "x": torch.from_numpy(x.view(np.int32)),
                  "out": dm.dft_matmul(torch.from_numpy(x.view(np.int32)),
                                       mats[0], mats[1], m).numpy()}
    return out


def test_jax_cache_settings_survive_the_probe_import(jax_side):
    after = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    assert after == jax_side["before"]
    assert os.path.basename(after["jax_compilation_cache_dir"]) == \
        ".jax_cache"


@pytest.mark.parametrize("m", SIZES)
def test_matrices_and_root_equal_jax(jax_side, port_side, m):
    M_lo, M_hi, w = port_side[m]["mats"]
    assert M_lo.dtype == M_hi.dtype == torch.bfloat16
    assert M_lo.shape == (m * 32, m * 32)
    assert w == jax_side[m]["w"]
    assert np.array_equal(M_lo.float().numpy(), jax_side[m]["M_lo"])
    assert np.array_equal(M_hi.float().numpy(), jax_side[m]["M_hi"])
    assert float(torch.maximum(M_lo, M_hi).max()) <= 15


def test_fold_table_equals_jax(jax_side):
    assert np.array_equal(dm.fold_table(), jax_side["fold"])
    assert dm.fold_table().dtype == np.uint32


def test_kernel_fold_constants_are_the_fold_table():
    """The two 16-limb constants written into csrc/dft_kernels.cu are
    columns 0 and 1 of fold_table()."""
    with open(os.path.join(ROOT, "halo2_tpu_torch", "csrc",
                           "dft_kernels.cu")) as fh:
        src = fh.read()
    for name, col in (("FOLD16", 0), ("FOLD17", 1)):
        body = re.search(name + r"\[16\] = \{([^}]*)\}", src).group(1)
        words = [int(v, 16) for v in re.findall(r"0x[0-9a-f]+", body)]
        assert words == [int(v) for v in dm.fold_table()[:, col]], name


@pytest.mark.parametrize("m", SIZES)
def test_bytes_from_limbs_equals_jax(jax_side, port_side, m):
    got = dm.bytes_from_limbs(port_side[m]["x"]).numpy()
    assert np.array_equal(got, jax_side[m]["bytes"].astype(np.int32))


@pytest.mark.parametrize("m", SIZES)
def test_dft_matmul_equals_jax_limb_for_limb(jax_side, port_side, m):
    got = port_side[m]["out"]
    assert got.shape == (17, m, B) and got.dtype == np.int32
    assert np.array_equal(got, jax_side[m]["out"].view(np.int32))


@pytest.mark.parametrize("m", SIZES)
def test_jax_matrices_carried_across_give_the_same_output(jax_side,
                                                          port_side, m):
    j = jax_side[m]
    got = dm.dft_matmul(port_side[m]["x"], torch.from_numpy(j["M_lo"]),
                        torch.from_numpy(j["M_hi"]), m)
    assert np.array_equal(got.numpy(), j["out"].view(np.int32))


@pytest.mark.parametrize("m", SIZES)
def test_output_congruent_to_host_dft(jax_side, port_side, m):
    _, cols = _inputs(m)
    w = port_side[m]["mats"][2]
    out = port_side[m]["out"]
    for b, xs in enumerate(cols):
        want = dm.host_dft(xs, w, m)
        assert want == jax_side["probe"].host_dft(xs, w, m)
        have = limbs_to_ints(out[:, :, b])
        assert [h % dm.P for h in have] == want, b
        assert max(have) < 1 << 271


@pytest.mark.parametrize("m", SIZES)
def test_plain_epilogue_on_extreme_sums(m):
    """The largest float32 sums the products can give at this m (every
    byte 15 * 255 * m * 32, in lo and hi) and zero: every carry position
    is exercised; the value of the sums is sum_t 17 v 2^(8t)."""
    for v in (m * 32 * 15 * 255, 0):
        s = torch.full((m * 32, 3), float(v), dtype=torch.float32)
        out = dm.dft_epilogue(s, s, m)
        assert out.shape == (17, m, 3) and out.dtype == torch.int32
        want = sum(17 * v << (8 * t) for t in range(32))
        for h in limbs_to_ints(out.reshape(17, -1).numpy()):
            assert h % dm.P == want % dm.P
            assert h < 1 << 271


@pytest.mark.parametrize("m", SIZES)
def test_probe_checks_pass_on_the_cpu(port_side, m):
    """examples/torch_mxu_dft_probe.py's own checks (host DFT mod p with an
    all-0xFF column, the CIOS NTT, K6 against its plain version) at a
    small B, with CPU tensors."""
    probe = _load("torch_mxu_dft_probe",
                  os.path.join(ROOT, "examples", "torch_mxu_dft_probe.py"))
    mats = port_side[m]["mats"]
    x = probe.probe_input(m, 6, "cpu")
    res = probe.check(x, dm.dft_matmul(x, mats[0], mats[1], m), mats, m)
    assert res["exact_mod_p"] and res["ntt_agrees"]
    assert res["all_ff_column_checked"]
    assert res["epilogue_max_abs_err"] == 0


def test_too_large_a_transform_raises():
    with pytest.raises(ValueError, match="exact"):
        dm.dft_matrices(256, "cpu")
    with pytest.raises(ValueError, match="exact"):
        dm.dft_matrices(128, "cpu", nb_in=35)
    with pytest.raises(ValueError, match="power of two"):
        dm.dft_matrices(24, "cpu")


def test_epilogue_wrapper_refuses_bad_arguments():
    s = torch.zeros((16 * 32, 4), dtype=torch.float32)
    with pytest.raises(TypeError):
        dm.dft_epilogue(s.double(), s, 16)
    with pytest.raises(ValueError):
        dm.dft_epilogue(s, s, 8)
    with pytest.raises(ValueError):
        dm.dft_epilogue(s, s[:, :3], 16)
    meta = torch.zeros((16 * 32, 4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dm.dft_epilogue(meta, meta, 16)
    with pytest.raises(ValueError):
        dm.dft_matmul(torch.zeros((16, 8, 4), dtype=torch.int64),
                      s, s, 8)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        dm.dft_matrices(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        dm.dft_matrices(16, "cuda")
