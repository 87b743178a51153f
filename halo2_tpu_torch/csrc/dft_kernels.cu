// The epilogue of the exact m-point DFT over Fr done as two nibble matrix
// products (ntt/dft_matmul.py): float32 byte-basis sums -> 17 16-bit limbs.
//
// Replaces the Pallas kernel examples/mxu_dft_probe.py::_epilogue_call.
// For every output element (j, b) the two products leave 32 float32 sums
// lo[j*32 + t][b] and hi[j*32 + t][b], exact integers below 2^24, whose
// combination b_t = lo_t + 16*hi_t is the (redundant) byte t of the DFT
// output.  The kernel
//   1. folds the 32 redundant bytes into 18 redundant 16-bit limbs,
//   2. ripples them to canonical limbs (the value is below 2^275),
//   3. folds limbs 16 and 17 through 2^256 mod p and 2^272 mod p, which
//      leaves a value below 2^256 + 2^17 p < 2^272 congruent mod p,
//   4. ripples that to 17 canonical limbs and writes them.
// The result is the integer the reference's plain dft_matmul computes,
// limb for limb.
//
// What bounds it on an H100: each element reads 64 float32 words and writes
// 17 int32 words (324 bytes) for about 490 32-bit integer operations, so
// 97 ps of memory traffic against 15 ps of arithmetic: bound by device
// memory.  The design reads every input word once and writes every output
// word once, one thread per output element, neighbouring threads on
// neighbouring columns b (every load and store coalesced), and keeps the 18
// limbs in registers.  No blocking over m and no padding of B: the TPU's
// (8, 128) tiling rules do not apply, the ragged edge is a bounds check.
//
// Plain C interface: the entry point launches on the given stream and
// returns cudaGetLastError() as an int.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;
constexpr int NB = 32;  // bytes of an input element, rows of lo/hi per j

// 16-bit limbs of 2^256 mod p and 2^272 mod p (p = the BN254 scalar field
// modulus), little-endian: ntt/dft_matmul.py::fold_table() columns 0 and 1.
__constant__ uint32_t FOLD16[16] = {
    0xfffb, 0x4fff, 0x341c, 0xac96, 0xcd29, 0x9f60, 0x7695, 0x36fc,
    0x462e, 0x7879, 0xa36f, 0x666e, 0xdf2f, 0x9a07, 0x77c1, 0x0e0a};
__constant__ uint32_t FOLD17[16] = {
    0xb5b9, 0x6ffa, 0x7098, 0x0f74, 0x76ad, 0x7031, 0x4017, 0x4f0b,
    0xc787, 0xf7c3, 0x616b, 0x5105, 0xeb95, 0x121f, 0xa313, 0x0d42};

// lo, hi: (m*32, B) float32, row-major.  out: (17, m, B) 32-bit words.
__global__ void dft_epilogue_kernel(const float* __restrict__ lo,
                                    const float* __restrict__ hi,
                                    uint32_t* __restrict__ out, int64_t m,
                                    int64_t B) {
  const int64_t n = m * B;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int64_t j = i / B;
    const int64_t b = i - j * B;
    const float* plo = lo + j * NB * B + b;
    const float* phi = hi + j * NB * B + b;

    // redundant bytes -> 18 redundant 16-bit limbs: byte 2k fills limb k,
    // byte 2k+1 its high half, and what byte 2k+1 holds above 8 bits
    // carries into limb k+1 (every limb stays below 2^30)
    uint32_t acc[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) acc[k] = 0;
#pragma unroll
    for (int k = 0; k < NB / 2; ++k) {
      const uint32_t b0 = __float2uint_rn(plo[(2 * k) * B]) +
                          (__float2uint_rn(phi[(2 * k) * B]) << 4);
      const uint32_t b1 = __float2uint_rn(plo[(2 * k + 1) * B]) +
                          (__float2uint_rn(phi[(2 * k + 1) * B]) << 4);
      acc[k] += b0 + ((b1 & 0xFFu) << 8);
      acc[k + 1] += b1 >> 8;
    }

    // ripple to 18 canonical limbs
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < 18; ++k) {
      const uint32_t t = acc[k] + c;
      acc[k] = t & 0xFFFFu;
      c = t >> 16;
    }

    // fold limbs 16 and 17 through 2^256 and 2^272 mod p
    const uint32_t l16 = acc[16];
    const uint32_t l17 = acc[17];
    acc[16] = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t f0 = l16 * FOLD16[k];  // < 2^32
      const uint32_t f1 = l17 * FOLD17[k];
      acc[k] += (f0 & 0xFFFFu) + (f1 & 0xFFFFu);
      acc[k + 1] += (f0 >> 16) + (f1 >> 16);
    }

    // ripple to 17 canonical limbs and write them
    c = 0;
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      const uint32_t t = acc[k] + c;
      out[k * n + i] = t & 0xFFFFu;
      c = t >> 16;
    }
  }
}

}  // namespace

extern "C" {

int h2_dft_epilogue(const void* lo, const void* hi, void* out, long long m,
                    long long B, void* stream) {
  const int64_t n = (int64_t)m * B;
  if (n <= 0) return 0;
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  dft_epilogue_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)lo, (const float*)hi, (uint32_t*)out, m, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
