"""halo2_tpu_torch NTT layer (the module of kernels K2 and K3) against the
JAX package and an O(n^2) host DFT, on the CPU.

The same inputs, made from a seed with numpy, go through `halo2_tpu` and
through the port with CPU tensors (the plain PyTorch versions).
Tolerance: none — limb words and decoded integers are compared for
equality.  The JAX side runs once per module, at the sizes
tests/test_ntt.py and tests/test_field.py already compile.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.fields.bn254 import Fr as JFr
from halo2_tpu.ntt.ntt import NTT as JNTT

from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields import limbs as tl
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.ntt.ntt import (NTT, bit_reverse_indices, get_ntt,
                                     powers_table_np)

torch.set_num_threads(1)

JAX_FORWARD = (3, 6)      # log sizes tests/test_ntt.py transforms forward
JAX_ROUNDTRIP = 4         # ... and both ways
MID, HALF, REP = 4, 16, 4  # butterfly / mul_tiled case: 64 elements


def _rand_ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def _naive_dft(vals, omega):
    n = len(vals)
    return [sum(v * pow(omega, i * j, P) for j, v in enumerate(vals)) % P
            for i in range(n)]


def _words(x):
    return tl.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for log_n in JAX_FORWARD:
        vals = _rand_ints(100 + log_n, 1 << log_n)
        out["forward", log_n] = _words(
            JNTT(log_n).forward(jnp.asarray(JFr.encode(vals))))
    vals = _rand_ints(100 + JAX_ROUNDTRIP, 1 << JAX_ROUNDTRIP)
    ntt = JNTT(JAX_ROUNDTRIP)
    evals = ntt.forward(jnp.asarray(JFr.encode(vals)))
    out["forward", JAX_ROUNDTRIP] = _words(evals)
    out["inverse", JAX_ROUNDTRIP] = _words(ntt.inverse(evals))
    # the expressions the kernels stand in for (ntt.py: u = lo + hi,
    # v = (lo - hi) * tw; x * mid), on flat 64-element arrays
    lo, hi, tw, t = (_rand_ints(s, MID * HALF) for s in (1, 2, 3, 4))
    twf = [tw[(j % HALF) // REP] for j in range(MID * HALF)]
    tf = [t[j % HALF] for j in range(MID * HALF)]
    jlo, jhi = jnp.asarray(JFr.encode(lo)), jnp.asarray(JFr.encode(hi))
    out["u"] = _words(JFr.add(jlo, jhi))
    out["v"] = _words(JFr.mul(JFr.sub(jlo, jhi), jnp.asarray(JFr.encode(twf))))
    out["tiled"] = _words(JFr.mul(jlo, jnp.asarray(JFr.encode(tf))))
    return out


def test_butterfly_matches_jax_expressions(jax_side):
    F = fr("cpu")
    lo, hi, tw = (_rand_ints(s, MID * HALF) for s in (1, 2, 3))
    x = torch.stack([F.encode(lo).reshape(16, MID, HALF),
                     F.encode(hi).reshape(16, MID, HALF)], dim=2)
    tw_t = F.encode(tw[:HALF // REP])
    uv = cuda_ops.butterfly(F, x[:, :, 0, :], x[:, :, 1, :], tw_t, rep=REP)
    assert uv.shape == (16, MID, 2, HALF)
    assert np.array_equal(_words(uv[:, :, 0, :].reshape(16, -1)),
                          jax_side["u"])
    assert np.array_equal(_words(uv[:, :, 1, :].reshape(16, -1)),
                          jax_side["v"])


def test_mul_tiled_matches_jax_expression(jax_side):
    F = fr("cpu")
    lo, t = _rand_ints(1, MID * HALF), _rand_ints(4, MID * HALF)
    got = cuda_ops.mul_tiled(F, F.encode(lo).reshape(16, MID, HALF),
                             F.encode(t[:HALF]))
    assert np.array_equal(_words(got.reshape(16, -1)), jax_side["tiled"])


@pytest.mark.parametrize("mid,half,rep", [(1, 1, 1), (3, 8, 1), (5, 6, 3),
                                          (2, 1000, 8)])
def test_butterfly_vs_ints(mid, half, rep):
    F = fr("cpu")
    lo, hi = _rand_ints(7, mid * half), _rand_ints(8, mid * half)
    tw = _rand_ints(9, half // rep)
    uv = cuda_ops.butterfly(F, F.encode(lo).reshape(16, mid, half),
                            F.encode(hi).reshape(16, mid, half),
                            F.encode(tw), rep=rep)
    assert F.decode(uv[:, :, 0, :].reshape(16, -1)) == \
        [(a + b) % P for a, b in zip(lo, hi)]
    assert F.decode(uv[:, :, 1, :].reshape(16, -1)) == \
        [(a - b) * tw[(j % half) // rep] % P
         for j, (a, b) in enumerate(zip(lo, hi))]


@pytest.mark.parametrize("mid,k", [(1, 1), (4, 3), (3, 1000)])
def test_mul_tiled_vs_ints(mid, k):
    F = fr("cpu")
    a, t = _rand_ints(10, mid * k), _rand_ints(11, k)
    got = cuda_ops.mul_tiled(F, F.encode(a).reshape(16, mid, k), F.encode(t))
    assert F.decode(got.reshape(16, -1)) == \
        [x * t[j % k] % P for j, x in enumerate(a)]


@pytest.mark.parametrize("log_n", JAX_FORWARD + (JAX_ROUNDTRIP,))
def test_forward_matches_jax(jax_side, log_n):
    F = fr("cpu")
    vals = _rand_ints(100 + log_n, 1 << log_n)
    got = get_ntt(log_n, "cpu").forward(F.encode(vals))
    assert np.array_equal(_words(got), jax_side["forward", log_n])


def test_inverse_matches_jax_and_round_trips(jax_side):
    F = fr("cpu")
    vals = _rand_ints(100 + JAX_ROUNDTRIP, 1 << JAX_ROUNDTRIP)
    ntt = get_ntt(JAX_ROUNDTRIP, "cpu")
    a = F.encode(vals)
    back = ntt.inverse(ntt.forward(a))
    assert np.array_equal(_words(back), jax_side["inverse", JAX_ROUNDTRIP])
    assert torch.equal(back, a)


@pytest.mark.parametrize("log_n", [0, 1, 2, 3, 5, 6])
def test_forward_and_inverse_vs_naive_dft(log_n):
    F = fr("cpu")
    n = 1 << log_n
    ntt = NTT(log_n, "cpu")
    vals = _rand_ints(200 + log_n, n)
    evals = ntt.forward(F.encode(vals))
    assert F.decode(evals) == _naive_dft(vals, ntt.omega)
    assert F.decode(ntt.inverse(evals)) == vals
    nodiv = F.decode(ntt.inverse_nodiv(evals))
    assert nodiv == [v * n % P for v in vals]


def test_batched_input():
    F = fr("cpu")
    log_n, n = 4, 16
    ntt = NTT(log_n, "cpu")
    cols = [_rand_ints(300 + c, n) for c in range(6)]
    a = torch.stack([F.encode(c) for c in cols], dim=1).reshape(16, 2, 3, n)
    out = ntt.forward(a)
    assert out.shape == a.shape
    flat = out.reshape(16, 6, n)
    for c in range(6):
        assert F.decode(flat[:, c]) == _naive_dft(cols[c], ntt.omega)
    assert torch.equal(ntt.inverse(out), a)


def test_custom_omega_coset_consistency():
    """A half-size NTT with omega^2 gives the even outputs of the full one."""
    F = fr("cpu")
    log_n = 5
    ntt = NTT(log_n, "cpu")
    half = NTT(log_n - 1, "cpu", omega=ntt.omega * ntt.omega % P)
    xs = _rand_ints(400, 1 << (log_n - 1))
    got = F.decode(half.forward(F.encode(xs)))
    full = F.decode(ntt.forward(F.encode(xs + [0] * (1 << (log_n - 1)))))
    assert got == full[0::2]


def test_tables_and_limits():
    assert bit_reverse_indices(3).tolist() == [0, 4, 2, 6, 1, 5, 3, 7]
    F = fr("cpu")
    tab = powers_table_np(3, 5, P, F.to_mont_int)
    assert F.decode(tl.to_tensor(tab, "cpu")) == [1, 3, 9, 27, 81]
    assert get_ntt(4, "cpu") is get_ntt(4, torch.device("cpu"))
    with pytest.raises(ValueError):
        NTT(29, "cpu")
    with pytest.raises(ValueError):
        get_ntt(3, "cpu").forward(F.encode([1, 2, 3, 4]))
