"""The G2 prepared-lines disk cache (HALO2_TPU_G2_CACHE) of the port's
pairing against the JAX package's (halo2_tpu/pairing/bn254.py): the same
key hash and file contents, so lines written by either package load in
the other; a second call in a fresh memory cache reads the file; `off`
writes nothing; a file that cannot be read, or that names a class, is
computed and written again.  Host Python only, on a `tmp_path` directory.
"""

import os
import pickle

import pytest

from halo2_tpu.pairing import bn254 as jpair

from halo2_tpu_torch.pairing import bn254 as pair

POINT = pair.g2_mul(pair.G2_GEN, 0x5EED)
J_POINT = jpair.g2_mul(jpair.G2_GEN, 0x5EED)


@pytest.fixture
def cache(monkeypatch, tmp_path):
    """Both packages' caches in one empty directory, memory caches empty."""
    for mod in (pair, jpair):
        monkeypatch.setattr(mod, "_G2_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(mod, "_PREPARED_CACHE", {})
    return tmp_path


def _no_compute(monkeypatch, mod):
    def refuse(self, q_g2):
        raise AssertionError("the lines were computed, not read")
    monkeypatch.setattr(mod.G2Prepared, "__init__", refuse)


def _wire(prep):
    return [(tag, None if m is None else m.coeffs, c.coeffs, has_y)
            for tag, m, c, has_y in prep.steps]


def _key(point):
    return (point[0].coeffs, point[1].coeffs)


def test_same_key_path(cache):
    assert pair._disk_path(_key(POINT)) == jpair._disk_path(_key(J_POINT))


def test_port_reads_the_jax_lines(cache, monkeypatch):
    want = _wire(jpair.prepare_g2(J_POINT))
    assert len(os.listdir(cache)) == 1
    _no_compute(monkeypatch, pair)
    assert _wire(pair.prepare_g2(POINT)) == want


def test_jax_reads_the_port_lines(cache, monkeypatch):
    want = _wire(pair.prepare_g2(POINT))
    _no_compute(monkeypatch, jpair)
    assert _wire(jpair.prepare_g2(J_POINT)) == want


def test_second_process_reads_the_file(cache, monkeypatch):
    first = pair.prepare_g2(POINT)
    assert pair.prepare_g2(POINT) is first       # the memory cache
    monkeypatch.setattr(pair, "_PREPARED_CACHE", {})
    _no_compute(monkeypatch, pair)
    again = pair.prepare_g2(POINT)
    assert again is not first and _wire(again) == _wire(first)
    # and the lines still verify: e(P, Q) against itself
    p = (1, 2)
    assert pair.pairing_check([(p, POINT), ((1, pair.Q - 2), POINT)])


@pytest.mark.parametrize("off", ["0", "off"])
def test_off_writes_nothing(cache, monkeypatch, off):
    monkeypatch.setattr(pair, "_G2_CACHE_DIR", off)
    assert pair._disk_path(_key(POINT)) is None
    pair.prepare_g2(POINT)
    assert os.listdir(cache) == []


def test_bad_files_are_computed_again(cache):
    path = pair._disk_path(_key(POINT))
    want = _wire(pair.G2Prepared(POINT))
    for blob in (b"not a pickle",
                 pickle.dumps(os.system),             # names a function
                 pickle.dumps([("x", None, (1,) * 12, False)])):
        with open(path, "wb") as fh:
            fh.write(blob)
        pair._PREPARED_CACHE.clear()
        assert _wire(pair.prepare_g2(POINT)) == want
        with open(path, "rb") as fh:
            assert pickle.load(fh) == want           # written again
