// The host codec of halo2_tpu_torch: a CPython extension, built by g++ at
// first use (native/__init__.py), for the witness path's per-value loops.
//
//   * longs_to_blob:  a list of ints -> N canonical 32-byte little-endian
//                     rows, each value reduced mod p (negative values and
//                     values >= p included); objects with __index__ count
//                     as ints, anything else raises TypeError.
//   * blob_to_longs:  N 32-byte little-endian rows -> a list of ints.
//   * encode_mont:    32-byte rows (< 2^256) -> the (16, N) Montgomery limb
//                     planes of the device layout (uint32 words holding
//                     16-bit limbs), x R mod p by a 4 x 64 CIOS product
//                     with R^2; the output is canonical for any input
//                     below 2^256 (a < R, R^2 < p: the product is < 2p
//                     before its one conditional subtraction).
//   * decode_mont:    the inverse: limb planes -> canonical 32-byte rows.
//   * counting_sort_u32: the range check's counting sort of u32 values in
//                     [min, max].
//
// Every function is held against its plain Python version by
// tests/test_torch_native.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cstdint>
#include <cstring>
#include <vector>

using u64 = uint64_t;
using u128 = __uint128_t;

struct Fp {
    u64 p[4];
    u64 pinv;   // -p^{-1} mod 2^64
    u64 r2[4];  // R^2 mod p
};

static inline void mont_mul(const Fp& f, const u64 a[4], const u64 b[4],
                            u64 out[4]) {
    // CIOS Montgomery multiplication, 4 x 64-bit words
    u64 t[5] = {0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)a[i] * b[j] + t[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 top = (u128)t[4] + carry;
        u64 t4 = (u64)top;
        u64 extra = (u64)(top >> 64);

        u64 m = t[0] * f.pinv;
        u128 cur = (u128)m * f.p[0] + t[0];
        carry = cur >> 64;
        for (int j = 1; j < 4; j++) {
            cur = (u128)m * f.p[j] + t[j] + carry;
            t[j - 1] = (u64)cur;
            carry = cur >> 64;
        }
        cur = (u128)t4 + carry;
        t[3] = (u64)cur;
        t[4] = extra + (u64)(cur >> 64);
    }
    u64 borrow = 0;
    u64 res[4];
    for (int j = 0; j < 4; j++) {
        u128 cur = (u128)t[j] - f.p[j] - borrow;
        res[j] = (u64)cur;
        borrow = (cur >> 64) ? 1 : 0;
    }
    bool ge = t[4] || !borrow;
    for (int j = 0; j < 4; j++) out[j] = ge ? res[j] : t[j];
}

static bool parse_fp(PyObject* tup, Fp& f) {
    // (p0..p3, pinv, r2_0..r2_3) as Python ints
    if (!PyTuple_Check(tup) || PyTuple_GET_SIZE(tup) != 9) {
        PyErr_SetString(PyExc_TypeError, "field constants: a 9-tuple");
        return false;
    }
    for (int i = 0; i < 4; i++)
        f.p[i] = PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(tup, i));
    f.pinv = PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(tup, 4));
    for (int i = 0; i < 4; i++)
        f.r2[i] = PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(tup, 5 + i));
    return !PyErr_Occurred();
}

// encode_mont(rows: bytes (N*32), consts) -> bytes: 16 planes of N uint32
static PyObject* encode_mont(PyObject*, PyObject* args) {
    Py_buffer buf;
    PyObject* consts;
    if (!PyArg_ParseTuple(args, "y*O", &buf, &consts)) return nullptr;
    Fp f;
    if (!parse_fp(consts, f) || buf.len % 32) {
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "rows: a multiple of 32 bytes");
        PyBuffer_Release(&buf);
        return nullptr;
    }
    Py_ssize_t n = buf.len / 32;
    const unsigned char* in = (const unsigned char*)buf.buf;
    PyObject* out_bytes = PyBytes_FromStringAndSize(nullptr, n * 16 * 4);
    if (!out_bytes) { PyBuffer_Release(&buf); return nullptr; }
    uint32_t* out = (uint32_t*)PyBytes_AS_STRING(out_bytes);

    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++) {
        u64 v[4], m[4];
        memcpy(v, in + 32 * i, 32);
        mont_mul(f, v, f.r2, m);  // v * R mod p
        for (int limb = 0; limb < 16; limb++)
            out[(Py_ssize_t)limb * n + i] =
                (uint32_t)((m[limb / 4] >> (16 * (limb % 4))) & 0xFFFF);
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&buf);
    return out_bytes;
}

// decode_mont(planes: bytes (16 planes of N u32), consts) -> bytes (N*32)
static PyObject* decode_mont(PyObject*, PyObject* args) {
    Py_buffer buf;
    PyObject* consts;
    if (!PyArg_ParseTuple(args, "y*O", &buf, &consts)) return nullptr;
    Fp f;
    if (!parse_fp(consts, f) || buf.len % 64) {
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "planes: 16 x N uint32");
        PyBuffer_Release(&buf);
        return nullptr;
    }
    Py_ssize_t n = buf.len / 64;
    const uint32_t* in = (const uint32_t*)buf.buf;
    PyObject* out_bytes = PyBytes_FromStringAndSize(nullptr, n * 32);
    if (!out_bytes) { PyBuffer_Release(&buf); return nullptr; }
    unsigned char* out = (unsigned char*)PyBytes_AS_STRING(out_bytes);

    Py_BEGIN_ALLOW_THREADS
    const u64 one[4] = {1, 0, 0, 0};
    for (Py_ssize_t i = 0; i < n; i++) {
        u64 v[4] = {0, 0, 0, 0};
        for (int limb = 0; limb < 16; limb++)
            v[limb / 4] |= (u64)(in[(Py_ssize_t)limb * n + i] & 0xFFFF)
                           << (16 * (limb % 4));
        u64 m[4];
        mont_mul(f, v, one, m);  // v / R mod p
        memcpy(out + 32 * i, m, 32);
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&buf);
    return out_bytes;
}

// counting_sort_u32(values: bytes of u32, min, max) -> bytes, sorted
static PyObject* counting_sort_u32(PyObject*, PyObject* args) {
    Py_buffer buf;
    unsigned long mn, mx;
    if (!PyArg_ParseTuple(args, "y*kk", &buf, &mn, &mx)) return nullptr;
    if (mx < mn || mx > 0xFFFFFFFFul) {
        PyBuffer_Release(&buf);
        PyErr_Format(PyExc_ValueError, "bad range [%lu, %lu]", mn, mx);
        return nullptr;
    }
    Py_ssize_t n = buf.len / 4;
    const uint32_t* in = (const uint32_t*)buf.buf;
    std::vector<Py_ssize_t> counts(mx - mn + 1, 0);
    for (Py_ssize_t i = 0; i < n; i++) {
        uint32_t v = in[i];
        if (v < mn || v > mx) {
            PyBuffer_Release(&buf);
            PyErr_Format(PyExc_ValueError, "value %u outside [%lu, %lu]",
                         v, mn, mx);
            return nullptr;
        }
        counts[v - mn]++;
    }
    PyObject* out_bytes = PyBytes_FromStringAndSize(nullptr, n * 4);
    if (!out_bytes) { PyBuffer_Release(&buf); return nullptr; }
    uint32_t* out = (uint32_t*)PyBytes_AS_STRING(out_bytes);
    Py_ssize_t pos = 0;
    for (size_t b = 0; b < counts.size(); b++)
        for (Py_ssize_t c = 0; c < counts[b]; c++)
            out[pos++] = (uint32_t)(mn + b);
    PyBuffer_Release(&buf);
    return out_bytes;
}

static int as_rows(PyObject* v, unsigned char* out) {
    // the 32 little-endian bytes of a nonnegative int below 2^256;
    // -1 with an OverflowError set for a negative or a wider one
#if PY_VERSION_HEX >= 0x030D0000
    return _PyLong_AsByteArray((PyLongObject*)v, out, 32, 1, 0, 1);
#else
    return _PyLong_AsByteArray((PyLongObject*)v, out, 32, 1, 0);
#endif
}

static bool below(const unsigned char* row, const u64 p[4]) {
    u64 w[4];
    memcpy(w, row, 32);
    for (int j = 3; j >= 0; j--)
        if (w[j] != p[j]) return w[j] < p[j];
    return false;
}

// longs_to_blob(values: list, p: int) -> bytes (N*32): each value reduced
// mod p.  The export of a degraded (>= 2^64) witness column: one CPython
// long API call a value, where the plain Python join pays a % and a
// to_bytes in the interpreter.
static PyObject* longs_to_blob(PyObject*, PyObject* args) {
    PyObject* list;
    PyObject* p_obj;
    if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &list, &PyLong_Type,
                          &p_obj))
        return nullptr;
    unsigned char pb[32];
    if (as_rows(p_obj, pb) < 0) return nullptr;
    u64 p[4];
    memcpy(p, pb, 32);
    Py_ssize_t n = PyList_GET_SIZE(list);
    PyObject* out_bytes = PyBytes_FromStringAndSize(nullptr, n * 32);
    if (!out_bytes) return nullptr;
    unsigned char* out = (unsigned char*)PyBytes_AS_STRING(out_bytes);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PyList_GET_ITEM(list, i);
        PyObject* v = PyNumber_Index(item);   // TypeError for a non-int
        if (!v) { Py_DECREF(out_bytes); return nullptr; }
        unsigned char* row = out + 32 * i;
        bool ok = as_rows(v, row) == 0;
        if (!ok) {
            if (!PyErr_ExceptionMatches(PyExc_OverflowError)) {
                Py_DECREF(v);
                Py_DECREF(out_bytes);
                return nullptr;
            }
            PyErr_Clear();
        }
        if (!ok || !below(row, p)) {
            // negative, wider than 256 bits, or >= p: v mod p, exactly
            PyObject* r = PyNumber_Remainder(v, p_obj);
            if (!r || as_rows(r, row) < 0) {
                Py_XDECREF(r);
                Py_DECREF(v);
                Py_DECREF(out_bytes);
                return nullptr;
            }
            Py_DECREF(r);
        }
        Py_DECREF(v);
    }
    return out_bytes;
}

// blob_to_longs(rows: bytes (N*32)) -> list of N nonnegative ints
static PyObject* blob_to_longs(PyObject*, PyObject* args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
    if (buf.len % 32) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "rows: a multiple of 32 bytes");
        return nullptr;
    }
    Py_ssize_t n = buf.len / 32;
    const unsigned char* in = (const unsigned char*)buf.buf;
    PyObject* list = PyList_New(n);
    if (!list) { PyBuffer_Release(&buf); return nullptr; }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* v = _PyLong_FromByteArray(in + 32 * i, 32, 1, 0);
        if (!v) {
            Py_DECREF(list);
            PyBuffer_Release(&buf);
            return nullptr;
        }
        PyList_SET_ITEM(list, i, v);
    }
    PyBuffer_Release(&buf);
    return list;
}

static PyMethodDef methods[] = {
    {"encode_mont", encode_mont, METH_VARARGS,
     "32-byte rows -> Montgomery limb planes"},
    {"decode_mont", decode_mont, METH_VARARGS,
     "Montgomery limb planes -> canonical 32-byte rows"},
    {"counting_sort_u32", counting_sort_u32, METH_VARARGS,
     "the range check's counting sort"},
    {"longs_to_blob", longs_to_blob, METH_VARARGS,
     "list of ints -> 32-byte rows, reduced mod p"},
    {"blob_to_longs", blob_to_longs, METH_VARARGS,
     "32-byte rows -> list of ints"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moddef = {
    PyModuleDef_HEAD_INIT, "_native", "halo2_tpu_torch host codec", -1,
    methods,
};

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&moddef); }
