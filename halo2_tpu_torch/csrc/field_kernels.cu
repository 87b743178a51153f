// Field kernels: elementwise binary ops, the NTT butterfly, and the
// shared-table product.  One thread per field element, grid-stride loops,
// any element count (the ragged edge is a bounds check, not padding).
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

}  // extern "C"
