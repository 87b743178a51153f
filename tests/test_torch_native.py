"""The port's host codec (halo2_tpu_torch/native) against its plain Python
versions: `longs_to_blob` on edge values, values >= p, negatives and
non-ints; Montgomery encode and decode on random limbs; the counting sort
against `sorted`; and a stale build that lacks a function rebuilt at first
use instead of crashing the caller."""

import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from halo2_tpu_torch import native
from halo2_tpu_torch.fields.bn254 import FQ_MODULUS, FR_MODULUS as P, fq, fr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = [0, 1, P - 1, P, P + 1, 2 * P + 3, (1 << 64) - 1, 1 << 64,
         (1 << 256) - 1, 1 << 256, (1 << 300) + 7, -1, -P, -(1 << 300),
         np.uint64((1 << 64) - 1), np.int64(-3), True]


def _rows(blob):
    return [int.from_bytes(blob[i:i + 32], "little")
            for i in range(0, len(blob), 32)]


def test_longs_to_blob_reduces_every_value_mod_p():
    blob = native.longs_to_blob(EDGES, P)
    assert blob == native.plain_longs_to_blob(EDGES, P)
    assert _rows(blob) == [int(v) % P for v in EDGES]
    assert all(v < P for v in _rows(blob))
    assert native.longs_to_blob([], P) == b""
    # a tuple and a numpy column go through as lists
    col = np.arange(5, dtype=np.uint64) * np.uint64(1 << 61)
    assert native.longs_to_blob(col, P) == native.plain_longs_to_blob(col, P)


@pytest.mark.parametrize("bad", [1.5, "5", None, [1]])
def test_longs_to_blob_refuses_non_ints(bad):
    with pytest.raises(TypeError):
        native.longs_to_blob([1, bad], P)
    with pytest.raises(TypeError):
        native.plain_longs_to_blob([1, bad], P)


@pytest.mark.parametrize("make", [fr, fq], ids=["fr", "fq"])
def test_encode_equals_the_plain_version(make):
    F = make("cpu")
    rng = random.Random(11)
    xs = [rng.randrange(-F.p, 1 << 258) for _ in range(300)] + EDGES
    want = F.plain_encode_np(xs)
    assert np.array_equal(native.encode_mont_np(xs, F), want)
    assert np.array_equal(F.encode_np(xs), want)
    # numpy columns: unsigned, signed with negatives, signed without
    for arr in (np.array([0, 5, (1 << 64) - 1], dtype=np.uint64),
                np.array([-1, 5, -123456789], dtype=np.int64),
                np.array([7, 0, 3], dtype=np.int32)):
        assert np.array_equal(F.encode_np(arr), F.plain_encode_np(arr))
    assert F.encode_np([]).shape == (16, 0)


@pytest.mark.parametrize("make", [fr, fq], ids=["fr", "fq"])
def test_decode_equals_the_plain_version(make):
    F = make("cpu")
    gen = np.random.default_rng(5)
    limbs = gen.integers(0, 1 << 16, size=(16, 257), dtype=np.uint32)
    limbs[:, 0] = 0xFFFF                     # 2^256 - 1: above p
    limbs[:, 1] = 0
    assert native.decode_mont_np(limbs, F) == F.plain_decode(limbs)
    assert F.decode(limbs) == F.plain_decode(limbs)
    # and the round trip through encode
    xs = [int(v) for v in gen.integers(0, 1 << 62, size=64)] + [F.p - 1]
    assert F.decode(F.encode_np(xs)) == xs


def test_blob_round_trip():
    vals = [0, 1, P - 1, (1 << 256) - 1]
    blob = b"".join(v.to_bytes(32, "little") for v in vals)
    assert native.blob_to_longs(blob) == vals
    with pytest.raises(ValueError):
        native.blob_to_longs(b"\x00" * 31)


def test_counting_sort_equals_sorted():
    rng = random.Random(3)
    vals = [rng.randrange(10, 300) for _ in range(1000)]
    assert native.counting_sort(vals, 10, 299) == sorted(vals)
    assert native.counting_sort(vals, 10, 299) == \
        native.plain_counting_sort(vals, 10, 299)
    assert native.counting_sort([], 0, 5) == []
    with pytest.raises(ValueError):
        native.counting_sort([3, 9], 0, 5)
    with pytest.raises(ValueError):
        native.plain_counting_sort([3, 9], 0, 5)


_STALE = r'''
#define PY_SSIZE_T_CLEAN
#include <Python.h>
static PyObject* encode_mont(PyObject*, PyObject*) { Py_RETURN_NONE; }
static PyMethodDef methods[] = {
    {"encode_mont", encode_mont, METH_VARARGS, ""},
    {nullptr, nullptr, 0, nullptr},
};
static struct PyModuleDef moddef = {
    PyModuleDef_HEAD_INIT, "_native", "", -1, methods,
};
PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&moddef); }
'''

_RUN = textwrap.dedent('''
    import os, sys
    from halo2_tpu_torch import native
    from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P
    native.BUILD_DIR = sys.argv[1]
    path = native.so_path()
    native.compile_source(sys.argv[2], path)        # the stale build
    stale = os.path.getsize(path)
    assert native._lib is None
    blob = native.longs_to_blob([P + 2, -1], P)
    assert blob == native.plain_longs_to_blob([P + 2, -1], P)
    assert not native._missing(native.lib())
    assert os.path.getsize(path) != stale           # replaced in place
    print("rebuilt")
''')


def test_a_stale_build_that_lacks_a_function_is_rebuilt(tmp_path):
    """A build under the codec's name that lacks `longs_to_blob` (a stale
    or truncated file) is rebuilt and loaded at first use; the caller gets
    its answer.  In a process of its own with a build directory of its
    own, so that no other test loads the stale file."""
    src = tmp_path / "stale.cpp"
    src.write_text(_STALE)
    done = subprocess.run(
        [sys.executable, "-c", _RUN, str(tmp_path / "build"), str(src)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "rebuilt" in done.stdout


def test_fq_constants_differ_from_fr():
    # one constants tuple a field: Fq's codec does not reuse Fr's
    assert native._consts(fq("cpu")) != native._consts(fr("cpu"))
    assert FQ_MODULUS != P
