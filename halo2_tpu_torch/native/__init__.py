"""The host codec: the witness path's per-value loops in C++.

`encoder.cpp` is a CPython extension (no pybind11), built by `g++` at first
use, never at import, into `halo2_tpu_torch/_build/`.  The file name of a
build holds a hash of the source and the flags, so a changed source gets a
build of its own; a build that lacks a function this module calls (a stale
or truncated file under that name) is rebuilt and loaded afresh.  A failed
build or load raises: there is no switch that turns the codec off and no
silent fallback.  The plain Python versions (`plain_longs_to_blob`,
`plain_counting_sort`, and `Field.plain_encode_np` / `Field.plain_decode`
in fields/limbs.py) are what the tests hold the codec against.

Every value goes out reduced mod p: negative values and values >= p are
reduced exactly (the CPython remainder), objects with `__index__` count as
ints, anything else raises TypeError.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import operator
import os
import subprocess
import sysconfig

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "encoder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
MODULE = "halo2_tpu_torch.native._native"
SYMBOLS = ("encode_mont", "decode_mont", "counting_sort_u32",
           "longs_to_blob", "blob_to_longs")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_consts_cache: dict = {}


def _include() -> str:
    return sysconfig.get_paths()["include"]


def so_path(source: str = SOURCE) -> str:
    """Where the build of `source` lives: a hash of its text and the flags
    in the name."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR,
                        f"_native_{digest.hexdigest()[:16]}{suffix}")


def compile_source(source: str, out: str) -> None:
    """g++ `source` into the extension `out` (written under a temporary
    name and moved into place, so concurrent builds never expose a torn
    file).  Raises RuntimeError with the compiler's output on failure."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = ["g++", *CXX_FLAGS, f"-I{_include()}", source, "-o", tmp]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed for {source}:\n{done.stderr}")
    os.replace(tmp, out)


def _load_from(path: str):
    loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
    spec = importlib.util.spec_from_file_location(MODULE, path,
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def _missing(mod) -> list:
    return [s for s in SYMBOLS if not hasattr(mod, s)]


def lib():
    """The extension module, built and loaded at the first call."""
    global _lib
    if _lib is not None:
        return _lib
    path = so_path()
    if not os.path.exists(path):
        compile_source(SOURCE, path)
    mod = _load_from(path)
    if _missing(mod):
        # a stale build under this name: build again, load the new file
        # under a name this process has not opened (the loader keeps the
        # old mapping by path), then put it in the old one's place
        fresh = f"{path}.{os.getpid()}.so"
        compile_source(SOURCE, fresh)
        mod = _load_from(fresh)
        os.replace(fresh, path)
        if _missing(mod):
            raise ImportError(f"the host codec lacks {_missing(mod)} after "
                              f"a rebuild of {SOURCE}")
    _lib = mod
    return mod


def _consts(field) -> tuple:
    key = (field.p, field.R2)
    if key not in _consts_cache:
        mask = (1 << 64) - 1
        p = field.p
        pinv64 = (-pow(p, -1, 1 << 64)) % (1 << 64)
        _consts_cache[key] = tuple(
            [(p >> (64 * i)) & mask for i in range(4)] + [pinv64]
            + [(field.R2 >> (64 * i)) & mask for i in range(4)])
    return _consts_cache[key]


# -- the codec ----------------------------------------------------------------

def longs_to_blob(values, p: int) -> bytes:
    """Ints -> N canonical 32-byte little-endian rows, each reduced mod p."""
    if not isinstance(values, list):
        values = list(values)
    return lib().longs_to_blob(values, p)


def plain_longs_to_blob(values, p: int) -> bytes:
    """`longs_to_blob`'s plain version: the Python join."""
    return b"".join((operator.index(v) % p).to_bytes(32, "little")
                    for v in values)


def blob_to_longs(blob: bytes) -> list:
    """N 32-byte little-endian rows -> N ints."""
    return lib().blob_to_longs(blob)


def encode_mont_blob(blob: bytes, field) -> np.ndarray:
    """N 32-byte little-endian rows -> (16, N) uint32 Montgomery limbs
    (16-bit limbs, one to a word)."""
    n = len(blob) // 32
    out = lib().encode_mont(blob, _consts(field))
    return np.frombuffer(out, dtype=np.uint32).reshape(16, n).copy()


def encode_mont_np(values, field) -> np.ndarray:
    """Ints (a sequence, or a numpy integer array) -> (16, N) uint32
    Montgomery limbs, every value reduced mod p first.  A numpy array of
    nonnegative values goes through as u64 rows with no Python work a
    value."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "iu" \
            and not (values.dtype.kind == "i" and values.size
                     and int(values.min()) < 0):
        quad = np.zeros((values.size, 4), dtype="<u8")
        quad[:, 0] = values.reshape(-1).astype(np.uint64)
        return encode_mont_blob(quad.tobytes(), field)
    if isinstance(values, np.ndarray):
        values = values.tolist()
    return encode_mont_blob(longs_to_blob(values, field.p), field)


def decode_mont_np(limbs, field) -> list:
    """(16, N) Montgomery limbs -> N canonical ints."""
    arr = np.ascontiguousarray(np.asarray(limbs), dtype=np.uint32)
    return blob_to_longs(lib().decode_mont(arr.tobytes(), _consts(field)))


def counting_sort(values, mn: int, mx: int) -> list:
    """The ints of `values`, all in [mn, mx] (ValueError otherwise),
    sorted by counting."""
    arr = np.asarray(values, dtype=np.uint32)
    out = lib().counting_sort_u32(arr.tobytes(), mn, mx)
    return np.frombuffer(out, dtype=np.uint32).tolist()


def plain_counting_sort(values, mn: int, mx: int) -> list:
    """`counting_sort`'s plain version."""
    vals = [int(v) for v in values]
    bad = [v for v in vals if not mn <= v <= mx]
    if bad:
        raise ValueError(f"value {bad[0]} outside [{mn}, {mx}]")
    return sorted(vals)
