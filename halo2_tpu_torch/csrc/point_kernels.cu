// G1 point kernels: one complete point operation per thread (add,
// add_mixed, double), the MSM scan step that takes its affine operand as
// packed words with a sign, and two chains of point operations that run
// whole inside one thread (the MSM's Horner combine over windows, and the
// double-and-add ladder of a scalar multiplication).  Coordinates are
// (16, n) limb arrays, see field.cuh.  Plain C interface: every entry point
// launches on the given stream and returns cudaGetLastError() as an int.
#include <cuda_runtime.h>

#include "point.cuh"

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

__device__ __forceinline__ Pt load_pt(const uint32_t* x, const uint32_t* y,
                                      const uint32_t* z, int64_t n,
                                      int64_t i) {
  Pt p;
  p.x = load_fe(x, n, i);
  p.y = load_fe(y, n, i);
  p.z = load_fe(z, n, i);
  return p;
}

__device__ __forceinline__ void store_pt(uint32_t* x, uint32_t* y,
                                         uint32_t* z, int64_t n, int64_t i,
                                         const Pt& p) {
  store_fe(x, n, i, p.x);
  store_fe(y, n, i, p.y);
  store_fe(z, n, i, p.z);
}

__global__ void __launch_bounds__(THREADS) point_add_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
    const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Pt p = load_pt(px, py, pz, n, i);
    Pt q = load_pt(qx, qy, qz, n, i);
    store_pt(ox, oy, oz, n, i, add_complete(p, q));
  }
}

__global__ void __launch_bounds__(THREADS) point_add_mixed_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
    const uint32_t* __restrict__ qy, uint32_t* __restrict__ ox,
    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Pt p = load_pt(px, py, pz, n, i);
    Fe x2 = load_fe(qx, n, i);
    Fe y2 = load_fe(qy, n, i);
    store_pt(ox, oy, oz, n, i, add_mixed(p, x2, y2));
  }
}

__global__ void __launch_bounds__(THREADS) point_double_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Pt p = load_pt(px, py, pz, n, i);
    store_pt(ox, oy, oz, n, i, double_complete(p));
  }
}

// The affine operand arrives packed, two 16-bit limbs per word: rows 0-7
// of `packed` are x, rows 8-15 are y, so a packed row IS a register word.
// y is negated where sign is 1; then a complete mixed add onto the carry.
__global__ void __launch_bounds__(THREADS) add_mixed_packed_kernel(
    const uint32_t* __restrict__ cx, const uint32_t* __restrict__ cy,
    const uint32_t* __restrict__ cz, const uint32_t* __restrict__ packed,
    const int32_t* __restrict__ sign, uint32_t* __restrict__ ox,
    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Pt p = load_pt(cx, cy, cz, n, i);
    Fe x2, y2;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      x2.w[k] = packed[(int64_t)k * n + i];
      y2.w[k] = packed[(int64_t)(NW + k) * n + i];
    }
    if (sign[i] != 0) y2 = neg_mod<FQ>(y2);
    store_pt(ox, oy, oz, n, i, add_mixed(p, x2, y2));
  }
}

// acc = T[W-1]; for w = W-2 down to 0: c complete doublings, then a
// complete add of T[w]; then `tail` more doublings.  One thread a lane,
// every intermediate in registers.  T[lane, w] of a coordinate sits at
// t + lane*lane_s + w*win_s, limb rows t_ls apart.  Stands for
// halo2_tpu/msm/msm.py:152 _combine_windows (a lax.scan over windows) and,
// with W = 1, c = 0, for the M*E_M doublings of the Abel sum
// (halo2_tpu/msm/sorted.py:314).  The same formulas in the same order as
// the plain version, so the projective limbs are equal.  Bound by the
// latency of one thread's chain, (W - 1)(c + 1) + tail dependent point
// operations: a few lanes never fill the card.
__global__ void __launch_bounds__(THREADS) point_horner_kernel(
    const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
    const uint32_t* __restrict__ tz, int64_t t_ls, int64_t lane_s,
    int64_t win_s, int64_t lanes, int W, int c, int tail,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < lanes; i += step) {
    const int64_t base = i * lane_s;
    Pt acc;
    acc.x = load_fe(tx, t_ls, base + (int64_t)(W - 1) * win_s);
    acc.y = load_fe(ty, t_ls, base + (int64_t)(W - 1) * win_s);
    acc.z = load_fe(tz, t_ls, base + (int64_t)(W - 1) * win_s);
    for (int w = W - 2; w >= 0; --w) {
      for (int k = 0; k < c; ++k) acc = double_complete(acc);
      Pt t;
      t.x = load_fe(tx, t_ls, base + (int64_t)w * win_s);
      t.y = load_fe(ty, t_ls, base + (int64_t)w * win_s);
      t.z = load_fe(tz, t_ls, base + (int64_t)w * win_s);
      acc = add_complete(acc, t);
    }
    for (int k = 0; k < tail; ++k) acc = double_complete(acc);
    store_pt(ox, oy, oz, lanes, i, acc);
  }
}

// k_i * P_i for affine P_i (never the identity) and standard-form scalar
// limbs: over the 256 bits, least significant first, acc += base where the
// bit is set, then base = 2 * base (not after the last bit).  One thread a
// point.  Stands for halo2_tpu/curves/g1.py:141 scalar_mul (a lax.scan
// over the bits); the same sequence of complete formulas as the plain
// version, so the projective limbs are equal.  Bound by operations: up to
// 256 adds and 255 doublings a point, some 5,100 products of 264 integer
// multiply-adds, on 160 bytes in and 192 out.
__global__ void __launch_bounds__(THREADS) point_ladder_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    int64_t p_ls, int64_t p_es, const uint32_t* __restrict__ s,
    int64_t s_ls, int64_t s_es, uint32_t* __restrict__ ox,
    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Pt base;
    base.x = load_fe(x, p_ls, i * p_es);
    base.y = load_fe(y, p_ls, i * p_es);
    base.z = one_mont<FQ>();
    Pt acc;                                   // the identity (0 : 1 : 0)
    acc.x = fe_zero();
    acc.y = one_mont<FQ>();
    acc.z = fe_zero();
    for (int l = 0; l < NL; ++l) {
      const uint32_t limb = s[(int64_t)l * s_ls + i * s_es];
      for (int b = 0; b < 16; ++b) {
        if ((limb >> b) & 1u) acc = add_complete(acc, base);
        if (l < NL - 1 || b < 15) base = double_complete(base);
      }
    }
    store_pt(ox, oy, oz, n, i, acc);
  }
}

}  // namespace

extern "C" {

// Resident blocks of THREADS threads a multiprocessor can hold for kernel
// `which` (0 add, 1 add_mixed, 2 double, 3 add_mixed_packed, 4 horner,
// 5 ladder), from the CUDA occupancy calculator.
int h2_point_occupancy(int which, int* blocks) {
  const void* fns[] = {(const void*)point_add_kernel,
                       (const void*)point_add_mixed_kernel,
                       (const void*)point_double_kernel,
                       (const void*)add_mixed_packed_kernel,
                       (const void*)point_horner_kernel,
                       (const void*)point_ladder_kernel};
  if (which < 0 || which >= 6) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fns[which], THREADS, 0);
}

int h2_point_add(const void* px, const void* py, const void* pz,
                 const void* qx, const void* qy, const void* qz, void* ox,
                 void* oy, void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  point_add_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz,
      (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)qz,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

int h2_point_add_mixed(const void* px, const void* py, const void* pz,
                       const void* qx, const void* qy, void* ox, void* oy,
                       void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  point_add_mixed_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz,
      (const uint32_t*)qx, (const uint32_t*)qy, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

int h2_point_double(const void* px, const void* py, const void* pz, void* ox,
                    void* oy, void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  point_double_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

int h2_add_mixed_packed(const void* cx, const void* cy, const void* cz,
                        const void* packed, const void* sign, void* ox,
                        void* oy, void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  add_mixed_packed_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cx, (const uint32_t*)cy, (const uint32_t*)cz,
      (const uint32_t*)packed, (const int32_t*)sign, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

int h2_point_horner(const void* tx, const void* ty, const void* tz,
                    long long t_ls, long long lane_s, long long win_s,
                    long long lanes, int W, int c, int tail, void* ox,
                    void* oy, void* oz, void* stream) {
  if (lanes <= 0) return 0;
  if (W < 1 || c < 0 || tail < 0) return (int)cudaErrorInvalidValue;
  point_horner_kernel<<<grid_for(lanes), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tx, (const uint32_t*)ty, (const uint32_t*)tz, t_ls,
      lane_s, win_s, lanes, W, c, tail, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz);
  return (int)cudaGetLastError();
}

int h2_point_ladder(const void* x, const void* y, long long p_ls,
                    long long p_es, const void* s, long long s_ls,
                    long long s_es, void* ox, void* oy, void* oz,
                    long long n, void* stream) {
  if (n <= 0) return 0;
  point_ladder_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, p_ls, p_es,
      (const uint32_t*)s, s_ls, s_es, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
