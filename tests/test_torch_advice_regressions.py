"""The port's side of tests/test_advice_regressions.py: signed negative
numpy advice reduces mod p and never wraps through uint64 (in the witness
collection and in the host codec); the unsigned column fast path stays;
the vanishing argument's blinding coefficients are uniform over Fr; range
check bounds are u32.  Where the JAX package computes the same thing on
the host, the port is held to its values too."""

import random

import numpy as np
import pytest

from halo2_tpu.fields.bn254 import Fr as JaxFr
from halo2_tpu.plonk.prover import WitnessCollection as JaxWitness
from halo2_tpu_torch import native
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P, fr
from halo2_tpu_torch.plonk.prover import WitnessCollection

F = fr("cpu")


def _mini_cs(num_advice=1):
    class _CS:
        num_advice_columns = num_advice
    return _CS()


def _column():
    class _Col:
        index = 0
    return _Col()


def test_assign_advice_bulk_signed_negatives_reduce_mod_p():
    vals = np.array([-1, -7, 3, 0], dtype=np.int64)
    wc = WitnessCollection(_mini_cs(), 16, 14, [])
    wc.assign_advice_bulk(_column(), 0, vals)
    expect = [int(v) % P for v in vals]
    assert [int(wc.advice[0][i]) for i in range(4)] == expect
    assert wc.max_value[0] == max(expect)
    jax_wc = JaxWitness(_mini_cs(), 16, 14, [])
    jax_wc.assign_advice_bulk(_column(), 0, vals)
    assert [int(v) for v in wc.advice[0]] == [int(v) for v in jax_wc.advice[0]]
    assert wc.max_value == jax_wc.max_value


def test_assign_advice_bulk_unsigned_fast_path_unchanged():
    wc = WitnessCollection(_mini_cs(), 16, 14, [])
    vals = np.array([5, 7, 11], dtype=np.uint64)
    wc.assign_advice_bulk(_column(), 0, vals)
    assert isinstance(wc.advice[0], np.ndarray)
    assert wc.advice[0][:3].tolist() == [5, 7, 11]
    assert wc.max_value[0] == 11


def test_native_encode_signed_negatives_match_list_path():
    signed = np.array([-1, 5, -123456789], dtype=np.int64)
    via_array = native.encode_mont_np(signed, F)
    via_list = native.encode_mont_np([int(v) for v in signed], F)
    assert np.array_equal(via_array, via_list)
    assert np.array_equal(via_array, F.plain_encode_np(signed))
    # the JAX package's host encoder gives the same limbs
    assert np.array_equal(via_array, np.asarray(JaxFr.encode(signed)))


def test_vanishing_random_coeffs_uniform_over_fr():
    from halo2_tpu_torch.plonk.vanishing import VanishingProver
    from halo2_tpu_torch.poly.domain import EvaluationDomain
    rng = random.Random(1234)
    domain = EvaluationDomain(2, 6, "cpu")
    limbs = VanishingProver._random_coeffs(rng, domain)
    vals = F.decode(limbs)
    assert len(vals) == 64
    assert all(0 <= v < P for v in vals)
    # uniform mod p puts ~33.6 % of the draws above 2^253; a sampler
    # truncated to [0, 2^253) never does (failing by luck: ~4e-12)
    assert any(v >= (1 << 253) for v in vals)


def test_range_check_rel_rejects_negative_min():
    from halo2_tpu_torch.plonk.range_check import RangeCheckRel
    with pytest.raises(AssertionError):
        RangeCheckRel(_column(), _column(), -1, 5, 1)
    with pytest.raises(AssertionError):
        RangeCheckRel(_column(), _column(), 0, 1 << 33, 1)
