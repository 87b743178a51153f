// Field kernels: elementwise binary ops, the NTT butterfly, the
// shared-table product, a power by a static exponent, and the three passes
// of the prefix-product scan.  One thread per field element (per chunk in
// the scan), grid-stride loops, any element count (the ragged edge is a
// bounds check, not padding).
// Plain C interface: every entry point launches on the given stream and
// returns cudaGetLastError() as an int.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace h2;

namespace {

constexpr int THREADS = 128;
constexpr int MAX_BLOCKS = 132 * 16;

inline int grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return (int)blocks;
}

enum { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2 };

template <int OP, int F>
__device__ __forceinline__ Fe apply(const Fe& x, const Fe& y) {
  if (OP == OP_ADD) return add_mod<F>(x, y);
  if (OP == OP_SUB) return sub_mod<F>(x, y);
  return mont_mul<F>(x, y);
}

// out[i] = a[i] (op) b[i].  Each operand has its own limb stride and
// element stride, so an operand that is one element (element stride 0) is
// broadcast without being materialised.
template <int OP, int F>
__global__ void binop_kernel(const uint32_t* __restrict__ a, int64_t a_ls,
                             int64_t a_es, const uint32_t* __restrict__ b,
                             int64_t b_ls, int64_t b_es,
                             uint32_t* __restrict__ out, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Fe x = load_fe(a, a_ls, i * a_es);
    Fe y = load_fe(b, b_ls, i * b_es);
    store_fe(out, n, i, apply<OP, F>(x, y));
  }
}

// Radix-2 DIF butterfly over `mid` rows of `half` elements:
//   u = lo + hi,  v = (lo - hi) * tw[(j % half) / rep]
// lo/hi rows are `in_rs` words apart (they are the two halves of one
// 2*half block of the same array), the outputs are written as the two
// halves of row r of a contiguous (16, mid, 2, half) array.
template <int F>
__global__ void butterfly_kernel(const uint32_t* __restrict__ lo,
                                 const uint32_t* __restrict__ hi,
                                 int64_t in_ls, int64_t in_rs,
                                 const uint32_t* __restrict__ tw,
                                 int64_t tw_len, int64_t rep,
                                 uint32_t* __restrict__ out, int64_t mid,
                                 int64_t half) {
  const int64_t n = mid * half;
  const int64_t out_ls = 2 * n;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int64_t r = i / half;
    const int64_t c = i - r * half;
    Fe x = load_fe(lo, in_ls, r * in_rs + c);
    Fe y = load_fe(hi, in_ls, r * in_rs + c);
    Fe w = load_fe(tw, tw_len, c / rep);
    Fe u = add_mod<F>(x, y);
    Fe v = mont_mul<F>(sub_mod<F>(x, y), w);
    store_fe(out, out_ls, r * 2 * half + c, u);
    store_fe(out, out_ls, r * 2 * half + half + c, v);
  }
}

// out[j] = a[j] * t[j % k] for j < mid*k: a table shared by every row
template <int F>
__global__ void mul_tiled_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ t,
                                 uint32_t* __restrict__ out, int64_t mid,
                                 int64_t k) {
  const int64_t n = mid * k;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Fe x = load_fe(a, n, i);
    Fe y = load_fe(t, k, i % k);
    store_fe(out, n, i, mont_mul<F>(x, y));
  }
}

// A static exponent: little-endian 32-bit words and its bit length.
struct Exponent {
  uint32_t w[NW];
  int nbits;
};

// out[i] = a[i]^e.  Stands for halo2_tpu/fields/limbs.py:533 pow_static
// (a lax.scan over the exponent's bits): square and multiply, most
// significant bit first, in registers.  One element a thread; the exponent
// is the same for every thread, so the branch never diverges.  Bound by
// operations: a 254-bit exponent is some 380 dependent products of 264
// integer multiply-adds, on 128 bytes moved an element; at a few elements
// (an inversion) it is one thread's latency.
template <int F>
__global__ void pow_kernel(const uint32_t* __restrict__ a, int64_t a_ls,
                           int64_t a_es, uint32_t* __restrict__ out,
                           int64_t n, Exponent e) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Fe r;
    if (e.nbits == 0) {
      r = one_mont<F>();
    } else {
      const Fe x = load_fe(a, a_ls, i * a_es);
      r = x;
      // the words are indexed statically (unrolled), so the exponent
      // stays in the parameter bank; bits from nbits - 2 down to 0
#pragma unroll
      for (int k = NW - 1; k >= 0; --k) {
        const uint32_t word = e.w[k];
        for (int b = 31; b >= 0; --b) {
          if (32 * k + b > e.nbits - 2) continue;
          r = mont_sqr<F>(r);
          if ((word >> b) & 1u) r = mont_mul<F>(r, x);
        }
      }
    }
    store_fe(out, n, i, r);
  }
}

// The prefix-product scan, in three passes.  Stands for
// halo2_tpu/fields/limbs.py:559 prefix_mul (two lax.scans).  Logical
// element j of the input sits at a + j*a_es and its prefix goes to
// out + j*o_es; a reverse scan is the same kernels given pointers to the
// last element and negated element strides.  The n elements are cut into
// C chunks of L (the last one may be short).  Bound by the latency of the
// dependent products: L + 2 * ceil(C / SCAN_THREADS) + log2(SCAN_THREADS)
// of them in a row, against 256 bytes an element moved.
constexpr int SCAN_THREADS = 512;   // the one block of pass 2
constexpr int SCAN_CHUNK_THREADS = 32;

// Pass 1: one thread a chunk keeps the running product in registers,
// writes the chunk's prefixes and its total.
template <int F>
__global__ void __launch_bounds__(SCAN_CHUNK_THREADS)
    scan_chunks_kernel(const uint32_t* __restrict__ a, int64_t a_ls,
                       int64_t a_es, uint32_t* __restrict__ out,
                       int64_t o_ls, int64_t o_es,
                       uint32_t* __restrict__ totals, int64_t n, int64_t L,
                       int64_t C) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int64_t j0 = c * L;
  const int64_t j1 = j0 + L < n ? j0 + L : n;
  Fe acc = load_fe(a, a_ls, j0 * a_es);
  store_fe(out, o_ls, j0 * o_es, acc);
  for (int64_t j = j0 + 1; j < j1; ++j) {
    acc = mont_mul<F>(acc, load_fe(a, a_ls, j * a_es));
    store_fe(out, o_ls, j * o_es, acc);
  }
  store_fe(totals, C, c, acc);
}

// Pass 2: one block turns the C chunk totals, in place, into exclusive
// prefix products.  Each thread folds a run of `per` totals in registers,
// the block scans the runs' products in shared memory (Hillis-Steele),
// and each thread writes its run's exclusive prefixes.
template <int F>
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_totals_kernel(uint32_t* __restrict__ totals, int64_t C,
                       int64_t per) {
  __shared__ Fe run[SCAN_THREADS];
  const int t = threadIdx.x;
  const int64_t c0 = t * per;
  const int64_t c1 = c0 + per < C ? c0 + per : C;
  Fe acc = one_mont<F>();
  for (int64_t c = c0; c < c1; ++c) acc = mont_mul<F>(acc, load_fe(totals, C, c));
  run[t] = acc;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    Fe v = run[t];
    if (t >= off) v = mont_mul<F>(run[t - off], v);
    __syncthreads();
    run[t] = v;
    __syncthreads();
  }
  Fe ex = t ? run[t - 1] : one_mont<F>();
  for (int64_t c = c0; c < c1; ++c) {
    const Fe x = load_fe(totals, C, c);
    store_fe(totals, C, c, ex);
    ex = mont_mul<F>(ex, x);
  }
}

// Pass 3: every element past the first chunk takes its chunk's exclusive
// prefix in; coalesced over the batch axis.
template <int F>
__global__ void scan_fold_kernel(uint32_t* __restrict__ out, int64_t o_ls,
                                 int64_t o_es,
                                 const uint32_t* __restrict__ excl,
                                 int64_t n, int64_t L, int64_t C) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = L + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += step) {
    const Fe x = load_fe(out, o_ls, j * o_es);
    store_fe(out, o_ls, j * o_es, mont_mul<F>(x, load_fe(excl, C, j / L)));
  }
}

}  // namespace

extern "C" {

int h2_field_binop(int op, int field, const void* a, long long a_ls,
                   long long a_es, const void* b, long long b_ls,
                   long long b_es, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  const int g = grid_for(n);
#define H2_LAUNCH(OP, F)                                                  \
  binop_kernel<OP, F><<<g, THREADS, 0, s>>>(pa, a_ls, a_es, pb, b_ls, b_es, \
                                             po, n)
  if (field == FR) {
    if (op == OP_ADD) H2_LAUNCH(OP_ADD, FR);
    else if (op == OP_SUB) H2_LAUNCH(OP_SUB, FR);
    else if (op == OP_MUL) H2_LAUNCH(OP_MUL, FR);
    else return (int)cudaErrorInvalidValue;
  } else if (field == FQ) {
    if (op == OP_ADD) H2_LAUNCH(OP_ADD, FQ);
    else if (op == OP_SUB) H2_LAUNCH(OP_SUB, FQ);
    else if (op == OP_MUL) H2_LAUNCH(OP_MUL, FQ);
    else return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef H2_LAUNCH
  return (int)cudaGetLastError();
}

int h2_butterfly(int field, const void* lo, const void* hi, long long in_ls,
                 long long in_rs, const void* tw, long long tw_len,
                 long long rep, void* out, long long mid, long long half,
                 void* stream) {
  const int64_t n = (int64_t)mid * half;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  if (field == FR) {
    butterfly_kernel<FR><<<g, THREADS, 0, s>>>(
        (const uint32_t*)lo, (const uint32_t*)hi, in_ls, in_rs,
        (const uint32_t*)tw, tw_len, rep, (uint32_t*)out, mid, half);
  } else if (field == FQ) {
    butterfly_kernel<FQ><<<g, THREADS, 0, s>>>(
        (const uint32_t*)lo, (const uint32_t*)hi, in_ls, in_rs,
        (const uint32_t*)tw, tw_len, rep, (uint32_t*)out, mid, half);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int h2_mul_tiled(int field, const void* a, const void* t, void* out,
                 long long mid, long long k, void* stream) {
  const int64_t n = (int64_t)mid * k;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  if (field == FR) {
    mul_tiled_kernel<FR><<<g, THREADS, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)t, (uint32_t*)out, mid, k);
  } else if (field == FQ) {
    mul_tiled_kernel<FQ><<<g, THREADS, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)t, (uint32_t*)out, mid, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// words: the exponent's 8 little-endian 32-bit words; nbits its length
int h2_field_pow(int field, const void* a, long long a_ls, long long a_es,
                 void* out, long long n, const unsigned int* words,
                 int nbits, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > 32 * NW) return (int)cudaErrorInvalidValue;
  Exponent e;
  for (int k = 0; k < NW; ++k) e.w[k] = words[k];
  e.nbits = nbits;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  if (field == FR) {
    pow_kernel<FR><<<g, THREADS, 0, s>>>((const uint32_t*)a, a_ls, a_es,
                                         (uint32_t*)out, n, e);
  } else if (field == FQ) {
    pow_kernel<FQ><<<g, THREADS, 0, s>>>((const uint32_t*)a, a_ls, a_es,
                                         (uint32_t*)out, n, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a, out: pointers to logical element 0 (the last one for a reverse scan)
int h2_scan_chunks(int field, const void* a, long long a_ls, long long a_es,
                   void* out, long long o_ls, long long o_es, void* totals,
                   long long n, long long L, long long C, void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || C < 1 || (C - 1) * L >= n || C * L < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = (int)((C + SCAN_CHUNK_THREADS - 1) / SCAN_CHUNK_THREADS);
#define H2_LAUNCH(F)                                                        \
  scan_chunks_kernel<F><<<g, SCAN_CHUNK_THREADS, 0, s>>>(                   \
      (const uint32_t*)a, a_ls, a_es, (uint32_t*)out, o_ls, o_es,          \
      (uint32_t*)totals, n, L, C)
  if (field == FR) H2_LAUNCH(FR);
  else if (field == FQ) H2_LAUNCH(FQ);
  else return (int)cudaErrorInvalidValue;
#undef H2_LAUNCH
  return (int)cudaGetLastError();
}

int h2_scan_totals(int field, void* totals, long long C, long long per,
                   void* stream) {
  if (C <= 0) return 0;
  if (per < 1 || per * SCAN_THREADS < C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == FR) {
    scan_totals_kernel<FR><<<1, SCAN_THREADS, 0, s>>>((uint32_t*)totals, C,
                                                      per);
  } else if (field == FQ) {
    scan_totals_kernel<FQ><<<1, SCAN_THREADS, 0, s>>>((uint32_t*)totals, C,
                                                      per);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int h2_scan_fold(int field, void* out, long long o_ls, long long o_es,
                 const void* excl, long long n, long long L, long long C,
                 void* stream) {
  if (n <= L) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n - L);
  if (field == FR) {
    scan_fold_kernel<FR><<<g, THREADS, 0, s>>>(
        (uint32_t*)out, o_ls, o_es, (const uint32_t*)excl, n, L, C);
  } else if (field == FQ) {
    scan_fold_kernel<FQ><<<g, THREADS, 0, s>>>(
        (uint32_t*)out, o_ls, o_es, (const uint32_t*)excl, n, L, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
