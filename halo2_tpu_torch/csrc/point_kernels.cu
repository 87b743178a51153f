// G1 point kernels: one complete point operation per thread (add,
// add_mixed, double), and the MSM scan step that takes its affine operand
// as packed words with a sign.  Coordinates are (16, n) limb arrays, see
// field.cuh.  Plain C interface: every entry point launches on the given
// stream and returns cudaGetLastError() as an int.
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

__global__ void point_add_kernel(const uint32_t* __restrict__ px,
                                 const uint32_t* __restrict__ py,
                                 const uint32_t* __restrict__ pz,
                                 const uint32_t* __restrict__ qx,
                                 const uint32_t* __restrict__ qy,
                                 const uint32_t* __restrict__ qz,
                                 uint32_t* __restrict__ ox,
                                 uint32_t* __restrict__ oy,
                                 uint32_t* __restrict__ oz, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Pt p = load_pt(px, py, pz, n, i);
    Pt q = load_pt(qx, qy, qz, n, i);
    store_pt(ox, oy, oz, n, i, add_complete(p, q));
  }
}

__global__ void point_add_mixed_kernel(const uint32_t* __restrict__ px,
                                       const uint32_t* __restrict__ py,
                                       const uint32_t* __restrict__ pz,
                                       const uint32_t* __restrict__ qx,
                                       const uint32_t* __restrict__ qy,
                                       uint32_t* __restrict__ ox,
                                       uint32_t* __restrict__ oy,
                                       uint32_t* __restrict__ oz,
                                       int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Pt p = load_pt(px, py, pz, n, i);
    Fe x2 = load_fe(qx, n, i);
    Fe y2 = load_fe(qy, n, i);
    store_pt(ox, oy, oz, n, i, add_mixed(p, x2, y2));
  }
}

__global__ void point_double_kernel(const uint32_t* __restrict__ px,
                                    const uint32_t* __restrict__ py,
                                    const uint32_t* __restrict__ pz,
                                    uint32_t* __restrict__ ox,
                                    uint32_t* __restrict__ oy,
                                    uint32_t* __restrict__ oz, int64_t n) {
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
__global__ void add_mixed_packed_kernel(const uint32_t* __restrict__ cx,
                                        const uint32_t* __restrict__ cy,
                                        const uint32_t* __restrict__ cz,
                                        const uint32_t* __restrict__ packed,
                                        const int32_t* __restrict__ sign,
                                        uint32_t* __restrict__ ox,
                                        uint32_t* __restrict__ oy,
                                        uint32_t* __restrict__ oz,
                                        int64_t n) {
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

}  // namespace

extern "C" {

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

}  // extern "C"
