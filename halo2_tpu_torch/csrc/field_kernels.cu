// Field kernels: elementwise binary ops, the NTT butterfly, the
// shared-table product, a power by a static exponent, the inversion, the
// prefix-product scan, and the decode of canonical 32-byte rows.  One
// thread per field element (a block per tile in the scan and the decode),
// grid-stride loops, any element count (the ragged edge is a bounds check,
// not padding).
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

// A static exponent as a sliding-window schedule, made on the host
// (cuda_ops.pow_schedule): `entries` odd powers x, x^3, ..., x^(2 entries
// - 1) are built first; r starts at odd power `first` (-1: e = 0, r = 1);
// then each step squares r (step >> 4) times and, where (step & 15) is
// not 0, multiplies it by odd power (step & 15) - 1.
constexpr int POW_MAX_STEPS = 256;
constexpr int POW_MAX_ENTRIES = 8;  // windows of up to 4 bits

struct PowSchedule {
  uint16_t step[POW_MAX_STEPS];
  int32_t nsteps;
  int32_t first;
  int32_t entries;
};

// odd power j of this thread: word k at tab[(j * NW + k) * THREADS + t], so
// the threads of a warp read 32 consecutive words, one bank each
__device__ __forceinline__ void put_odd(uint32_t* tab, int j, const Fe& v) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    tab[(j * NW + k) * THREADS + threadIdx.x] = v.w[k];
}

__device__ __forceinline__ Fe get_odd(const uint32_t* tab, int j) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    r.w[k] = tab[(j * NW + k) * THREADS + threadIdx.x];
  return r;
}

// out[i] = a[i]^e.  Stands for halo2_tpu/fields/limbs.py:533 pow_static
// (a lax.scan of square and multiply over the exponent's bits).  Here a
// sliding window: for the square root's (q + 1) / 4 (252 bits, 109 set)
// 305 products with windows of 4 bits against 359 by square and multiply.
// One element a thread; each thread keeps its odd powers in its own
// column of shared memory (8 x 32 bytes), the schedule is the same for
// every thread (kernel parameters, read uniformly), so no branch diverges.
// 251 of the 305 are squares (mont_sqr).  Bound by operations: a product
// is 264 integer multiply-adds, a square 208, on 128 bytes moved an
// element.  0^e = 0 for e > 0 and x^0 = 1.  Its caller is the square root
// of a params file's points (curves/g1.py points_from_bytes); inversions
// go to inv_kernel.
template <int F>
__global__ void __launch_bounds__(THREADS) pow_kernel(
    const uint32_t* __restrict__ a, int64_t a_ls, int64_t a_es,
    uint32_t* __restrict__ out, int64_t n, PowSchedule sc) {
  __shared__ uint32_t tab[POW_MAX_ENTRIES * NW * THREADS];
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Fe r;
    if (sc.first < 0) {
      r = one_mont<F>();
    } else {
      const Fe x = load_fe(a, a_ls, i * a_es);
      put_odd(tab, 0, x);
      if (sc.entries > 1) {
        const Fe x2 = mont_sqr<F>(x);
        Fe y = x;
#pragma unroll 1
        for (int j = 1; j < sc.entries; ++j) {
          y = mont_mul<F>(y, x2);
          put_odd(tab, j, y);
        }
      }
      r = get_odd(tab, sc.first);
#pragma unroll 1
      for (int s = 0; s < sc.nsteps; ++s) {
        const uint32_t st = sc.step[s];
#pragma unroll 1
        for (uint32_t q = st >> 4; q > 0; --q) r = mont_sqr<F>(r);
        if (st & 15u) r = mont_mul<F>(r, get_odd(tab, (int)(st & 15u) - 1));
      }
    }
    store_fe(out, n, i, r);
  }
}

// ---------------------------------------------------------------------------
// inv: a^-1 by safegcd
// ---------------------------------------------------------------------------
//
// Stands for halo2_tpu/fields/limbs.py:533 pow_static with e = p - 2, the
// reference's inversion (a lax.scan of square and multiply).  Fermat's
// chain is 379 dependent Montgomery products on one thread; here the
// inverse is Bernstein and Yang's divsteps ("Fast constant-time gcd
// computation and modular inversion", 2019) in the 32-bit form of
// libsecp256k1's modinv32: signed 30-bit limbs, 30 divsteps a batch on
// 32-bit words that build a 2x2 transition matrix, the matrix applied to
// (f, g) and to (d, e), a fixed number of batches, no branch on the data.
//
// The batch count: Theorem 11.2 of the paper bounds the divsteps from
// delta = 1 to g = 0 by floor((49d + 57) / 17) for f^2 + 4g^2 <= 5 * 2^(2d),
// d >= 46.  Both moduli and every canonical input are below 2^254, so
// d = 254 and 735 divsteps suffice: 25 batches of 30 (750).  The count
// and the constants come from the wrapper (cuda_ops.inv_constants).
//
// The input is x = a R (Montgomery form, canonical); the divsteps give
// y = x^-1 = a^-1 R^-1, and one Montgomery product by R^3 mod p brings it
// to a^-1 R.  0 has no inverse and gives 0, as Fermat's power does.
// Bound by the latency of one thread's chain: some 750 divsteps of a few
// 32-bit operations each, against 128 bytes an element moved.

constexpr int32_t M30 = 0x3FFFFFFF;
constexpr int S30_LIMBS = 9;  // 9 x 30 = 270 bits hold 256 and a sign

struct S30 {
  int32_t v[S30_LIMBS];
};

struct InvConsts {
  int32_t p30[S30_LIMBS];  // p in 30-bit limbs
  uint32_t pinv30;         // p^-1 mod 2^30
  uint32_t r3[NW];         // R^3 mod p, canonical words
  int32_t batches;         // batches of 30 divsteps
};

struct Trans {
  int32_t u, v, q, r;  // the 2x2 matrix of 30 divsteps, scaled by 2^30
};

// 8 words (< 2^256) -> 9 limbs of 30 bits
__device__ __forceinline__ S30 to_s30(const Fe& x) {
  S30 r;
#pragma unroll
  for (int i = 0; i < S30_LIMBS; ++i) {
    const int bit = 30 * i, w = bit >> 5, s = bit & 31;
    uint32_t val = x.w[w] >> s;
    if (s > 2 && w + 1 < NW) val |= x.w[w + 1] << (32 - s);
    r.v[i] = (int32_t)val & M30;
  }
  return r;
}

// 9 limbs in [0, 2^30) of a value below 2^256 -> 8 words
__device__ __forceinline__ Fe from_s30(const S30& a) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int bit = 32 * k, i = bit / 30, s = bit % 30;  // s <= 14
    r.w[k] = ((uint32_t)a.v[i] >> s) | ((uint32_t)a.v[i + 1] << (30 - s));
  }
  return r;
}

// 30 divsteps on the low words of f (odd) and g; returns the new delta.
// c1 masks (delta > 0), c2 masks (g odd): where both hold, (f, g) becomes
// (g, (g - f) / 2) and delta 1 - delta, else g becomes (g + (g odd) f) / 2
// and delta 1 + delta.
__device__ __forceinline__ int32_t divsteps_30(int32_t delta, uint32_t f,
                                               uint32_t g, Trans& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    uint32_t c1 = (uint32_t)((-delta) >> 31);
    const uint32_t c2 = 0u - (g & 1u);
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;
    delta = (int32_t)(((uint32_t)delta ^ c1) - c1) + 1;
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t.u = (int32_t)u;
  t.v = (int32_t)v;
  t.q = (int32_t)q;
  t.r = (int32_t)r;
  return delta;
}

// (d, e) <- t (d, e) / 2^30 mod p, with multiples of p added so that the
// division is exact; d and e stay in (-2p, p)
__device__ __forceinline__ void update_de(S30& d, S30& e, const Trans& t,
                                          const InvConsts& c) {
  const int32_t u = t.u, v = t.v, q = t.q, r = t.r;
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
  int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
  md -= (int32_t)((c.pinv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((c.pinv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd += (int64_t)c.p30[0] * md;
  ce += (int64_t)c.p30[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < S30_LIMBS; ++i) {
    cd += (int64_t)u * d.v[i] + (int64_t)v * e.v[i] + (int64_t)c.p30[i] * md;
    ce += (int64_t)q * d.v[i] + (int64_t)r * e.v[i] + (int64_t)c.p30[i] * me;
    d.v[i - 1] = (int32_t)cd & M30;
    cd >>= 30;
    e.v[i - 1] = (int32_t)ce & M30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// (f, g) <- t (f, g) / 2^30, exact
__device__ __forceinline__ void update_fg(S30& f, S30& g, const Trans& t) {
  const int32_t u = t.u, v = t.v, q = t.q, r = t.r;
  int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
  int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < S30_LIMBS; ++i) {
    cf += (int64_t)u * f.v[i] + (int64_t)v * g.v[i];
    cg += (int64_t)q * f.v[i] + (int64_t)r * g.v[i];
    f.v[i - 1] = (int32_t)cf & M30;
    cf >>= 30;
    g.v[i - 1] = (int32_t)cg & M30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

__device__ __forceinline__ void carry_s30(S30& r) {
#pragma unroll
  for (int i = 0; i < S30_LIMBS - 1; ++i) {
    r.v[i + 1] += r.v[i] >> 30;
    r.v[i] &= M30;
  }
}

// r in (-2p, p), negated where `sign` is negative -> [0, p), limbs in
// [0, 2^30)
__device__ __forceinline__ void normalize_s30(S30& r, int32_t sign,
                                              const InvConsts& c) {
  int32_t cond_add = r.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < S30_LIMBS; ++i) r.v[i] += c.p30[i] & cond_add;
  const int32_t cond_neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < S30_LIMBS; ++i) r.v[i] = (r.v[i] ^ cond_neg) - cond_neg;
  carry_s30(r);
  cond_add = r.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < S30_LIMBS; ++i) r.v[i] += c.p30[i] & cond_add;
  carry_s30(r);
}

template <int F>
__global__ void inv_kernel(const uint32_t* __restrict__ a, int64_t a_ls,
                           int64_t a_es, uint32_t* __restrict__ out,
                           int64_t n, InvConsts c) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    S30 d, e, f, g = to_s30(load_fe(a, a_ls, i * a_es));
#pragma unroll
    for (int k = 0; k < S30_LIMBS; ++k) {
      d.v[k] = 0;
      e.v[k] = 0;
      f.v[k] = c.p30[k];
    }
    e.v[0] = 1;
    int32_t delta = 1;
#pragma unroll 1
    for (int b = 0; b < c.batches; ++b) {
      Trans t;
      delta = divsteps_30(delta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
      update_de(d, e, t, c);
      update_fg(f, g, t);
    }
    // g is 0 and f = +-gcd = +-1 (f = p where the input was 0, and d = 0)
    normalize_s30(d, f.v[8], c);
    Fe r3;
#pragma unroll
    for (int k = 0; k < NW; ++k) r3.w[k] = c.r3[k];
    store_fe(out, n, i, mont_mul<F>(from_s30(d), r3));
  }
}

// ---------------------------------------------------------------------------
// prefix_mul: one pass of tiles with a decoupled look-back
// ---------------------------------------------------------------------------
//
// Stands for halo2_tpu/fields/limbs.py:559 prefix_mul (two lax.scans).
// Logical element j of the input sits at a + j*a_es and its prefix goes
// to out + j*o_es; a reverse scan is the same kernel given pointers to the
// last element and negated element strides.
//
// The n elements are cut into tiles of SCAN_BLOCK * V consecutive logical
// elements, one a block, taken in the order blocks claim them (an atomic
// ticket, so every earlier tile's block is already running).  A tile:
//   1. is loaded coalesced (element v*SCAN_BLOCK + t by thread t) into
//      shared memory, a plane of words for each of the 8 words;
//   2. each thread turns its run of V consecutive elements into inclusive
//      prefixes, in place;
//   3. each warp scans its 32 runs' totals by __shfl_up_sync (5 levels),
//      warp 0 the 8 warps' totals (3 levels): the tile's aggregate, which
//      it publishes at once with flag AGGREGATE;
//   4. the look-back: every thread of the block takes one earlier tile,
//      waits for its flag, and the block multiplies their values up to the
//      nearest tile whose flag says PREFIX (a shuffle tree in each warp
//      that holds one of them, then one across the warps; one product, or
//      none, where the tile just before has its prefix); 256 tiles a
//      window, window after window until one holds a PREFIX; the tile's
//      inclusive prefix goes out with flag PREFIX;
//   5. each thread multiplies its run by the product of everything before
//      it, and the tile goes back out coalesced.
// The field product is commutative, so the order of the products does not
// matter, and the canonical results equal the plain version's.
//
// What bounds it: the latency of the chain of dependent products at the
// proofs' lengths, the integer rate at 2^22.  One launch (and a memset of
// the flags) whatever n is, every pass over the data one block a tile,
// the tile's chain (V - 1) + 5 + 3 + the look-back + 2 + V products, the
// work 2 + 5/V products an element.  The runs live in shared memory and
// every product of the kernel goes through a few call sites of scan_mul,
// so the code stays small whatever V is.

constexpr int SCAN_BLOCK = 256;
constexpr int SCAN_WARPS = SCAN_BLOCK / 32;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr uint32_t FLAG_AGGREGATE = 1;
constexpr uint32_t FLAG_PREFIX = 2;

// The scan's state, one buffer a call of 17 * tiles + 1 words: the tiles'
// aggregates (8 words each, from word 0), their inclusive prefixes (from
// 8 * tiles), their flags (from 16 * tiles) and the ticket counter (word
// 17 * tiles).  The flags and the counter are zeroed before each launch.

template <int F>
__device__ __noinline__ Fe scan_mul(Fe a, Fe b) {
  return mont_mul<F>(a, b);
}

__device__ __forceinline__ Fe shfl_up_fe(const Fe& x, int d) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = __shfl_up_sync(FULL_MASK, x.w[k], d);
  return r;
}

__device__ __forceinline__ Fe shfl_down_fe(const Fe& x, int d) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    r.w[k] = __shfl_down_sync(FULL_MASK, x.w[k], d);
  return r;
}

__device__ __forceinline__ Fe shfl_fe(const Fe& x, int src) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = __shfl_sync(FULL_MASK, x.w[k], src);
  return r;
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// 8 words of the state (32-byte aligned), read from L2
__device__ __forceinline__ Fe ld_words(const uint32_t* p) {
  const uint4 lo = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint4 hi = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
  Fe r;
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
  return r;
}

__device__ __forceinline__ void st_words(uint32_t* p, const Fe& x) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
}

// Tile element i in shared memory: word k at planes[k * plane + slot(i)],
// one pad word every 32 so that both the coalesced order (i = v *
// SCAN_BLOCK + t) and the runs' order (i = t * V + v) are free of bank
// conflicts.
__device__ __forceinline__ int tile_slot(int i) { return i + (i >> 5); }

__device__ __forceinline__ Fe ld_tile(const uint32_t* planes, int plane,
                                      int i) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = planes[k * plane + tile_slot(i)];
  return r;
}

__device__ __forceinline__ void st_tile(uint32_t* planes, int plane, int i,
                                        const Fe& x) {
#pragma unroll
  for (int k = 0; k < NW; ++k) planes[k * plane + tile_slot(i)] = x.w[k];
}

// The block's look-back for tile > 0: the product of every earlier tile.
// Every thread calls it; `part`, `prod` and `first` are shared scratch.
template <int F>
__device__ Fe look_back(const uint32_t* state, int64_t tiles, int64_t tile,
                        Fe* part, Fe* prod, int* first_s) {
  const uint32_t* const agg = state;
  const uint32_t* const incl = state + 8 * tiles;
  const uint32_t* const flags = state + 16 * tiles;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  Fe before = one_mont<F>();
  for (int64_t end = tile - 1, window = 0;; end -= SCAN_BLOCK, ++window) {
    const int64_t j = end - t;  // thread 0 takes the nearest earlier tile
    uint32_t f = FLAG_PREFIX;   // before tile 0: the empty product
    Fe v = one_mont<F>();
    if (j >= 0) {
      do {
        f = ld_acquire(flags + j);
      } while (f == 0);
      v = ld_words((f == FLAG_PREFIX ? incl : agg) + 8 * j);
    }
    if (t == 0) *first_s = SCAN_BLOCK;
    __syncthreads();
    if (f == FLAG_PREFIX) atomicMin(first_s, t);
    __syncthreads();
    // the threads up to the nearest PREFIX take part; the rest give one
    const int first = *first_s;
    const int count = first < SCAN_BLOCK ? first + 1 : SCAN_BLOCK;
    const int warps = (count + 31) >> 5;
    if (t >= count) v = one_mont<F>();
    if (warp < warps) {
      const int lanes = min(count - 32 * warp, 32);
#pragma unroll 1
      for (int m = 1; m < lanes; m <<= 1)
        v = scan_mul<F>(v, shfl_down_fe(v, m));
      if (lane == 0) part[warp] = v;
    }
    __syncthreads();
    if (warp == 0) {
      Fe w = lane < warps ? part[lane] : one_mont<F>();
#pragma unroll 1
      for (int m = 1; m < warps; m <<= 1)
        w = scan_mul<F>(w, shfl_down_fe(w, m));
      if (lane == 0) *prod = window ? scan_mul<F>(before, w) : w;
    }
    __syncthreads();
    before = *prod;
    if (first < SCAN_BLOCK) return before;
  }
}

template <int F, int V>
__global__ void __launch_bounds__(SCAN_BLOCK)
    scan_kernel(const uint32_t* __restrict__ a, int64_t a_ls, int64_t a_es,
                uint32_t* __restrict__ out, int64_t o_ls, int64_t o_es,
                int64_t n, uint32_t* __restrict__ state, int64_t tiles) {
  constexpr int T = SCAN_BLOCK * V, PLANE = T + T / 32;
  extern __shared__ uint32_t planes[];  // NW planes of PLANE words
  __shared__ Fe warp_pre[SCAN_WARPS];
  __shared__ Fe part[SCAN_WARPS];
  __shared__ Fe prod, aggregate;
  __shared__ uint32_t tile_id;
  __shared__ int first;
  uint32_t* const incl = state + 8 * tiles;
  uint32_t* const flags = state + 16 * tiles;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_id = atomicAdd(state + 17 * tiles, 1u);
  __syncthreads();
  const int64_t tile = tile_id;
  const int64_t base = tile * T;

  // 1. the tile, coalesced (past n: one, which leaves every product as is)
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = v * SCAN_BLOCK + t;
    const int64_t j = base + i;
    st_tile(planes, PLANE, i,
            j < n ? load_fe(a, a_ls, j * a_es) : one_mont<F>());
  }
  __syncthreads();
  // 2. the run's inclusive prefixes
  Fe run = ld_tile(planes, PLANE, t * V);
#pragma unroll 1
  for (int v = 1; v < V; ++v) {
    run = scan_mul<F>(run, ld_tile(planes, PLANE, t * V + v));
    st_tile(planes, PLANE, t * V + v, run);
  }
  // 3. the warp's inclusive scan of the runs' totals, then warp 0's of the
  //    warps' totals: each warp's exclusive prefix and the aggregate
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const Fe y = shfl_up_fe(run, d);
    if (lane >= d) run = scan_mul<F>(y, run);
  }
  Fe lane_pre = shfl_up_fe(run, 1);  // the warp's runs before this one
  if (lane == 0) lane_pre = one_mont<F>();
  if (lane == 31) warp_pre[warp] = run;
  __syncthreads();
  if (warp == 0) {
    Fe w = lane < SCAN_WARPS ? warp_pre[lane] : one_mont<F>();
#pragma unroll 1
    for (int d = 1; d < SCAN_WARPS; d <<= 1) {
      const Fe y = shfl_up_fe(w, d);
      if (lane >= d) w = scan_mul<F>(y, w);
    }
    Fe wex = shfl_up_fe(w, 1);
    const Fe agg = shfl_fe(w, SCAN_WARPS - 1);
    if (lane == 0) wex = one_mont<F>();
    if (lane < SCAN_WARPS) warp_pre[lane] = wex;
    if (lane == 0) {
      aggregate = agg;
      st_words(tile ? state + 8 * tile : incl, agg);
      st_release(flags + tile, tile ? FLAG_AGGREGATE : FLAG_PREFIX);
    }
  }
  __syncthreads();
  Fe pre = scan_mul<F>(warp_pre[warp], lane_pre);  // within the tile
  // 4. everything before the tile
  if (tile > 0) {
    const Fe before = look_back<F>(state, tiles, tile, part, &prod, &first);
    if (t == 0) {
      st_words(incl + 8 * tile, scan_mul<F>(before, aggregate));
      st_release(flags + tile, FLAG_PREFIX);
    }
    pre = scan_mul<F>(before, pre);
  }
  // 5. everything before the run, into each of its elements; then out
#pragma unroll 1
  for (int v = 0; v < V; ++v)
    st_tile(planes, PLANE, t * V + v,
            scan_mul<F>(pre, ld_tile(planes, PLANE, t * V + v)));
  __syncthreads();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = v * SCAN_BLOCK + t;
    const int64_t j = base + i;
    if (j < n) store_fe(out, o_ls, j * o_es, ld_tile(planes, PLANE, i));
  }
}

template <int F, int V>
int launch_scan(const void* a, long long a_ls, long long a_es, void* out,
                long long o_ls, long long o_es, long long n, uint32_t* state,
                long long tiles, cudaStream_t s) {
  constexpr int T = SCAN_BLOCK * V;
  constexpr int smem = NW * (T + T / 32) * (int)sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<F, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  scan_kernel<F, V><<<(unsigned)tiles, SCAN_BLOCK, smem, s>>>(
      (const uint32_t*)a, a_ls, a_es, (uint32_t*)out, o_ls, o_es, n, state,
      tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode_le32: canonical 32-byte rows -> Montgomery limbs
// ---------------------------------------------------------------------------
//
// Replaces no Pallas kernel: the JAX package decodes a witness file's rows
// and the vanishing blind's random bytes on the host (numpy), and so did
// the port before this kernel.  Here the rows go up to the card as they
// lie in the file or in the blob, 32 bytes a value, and one launch makes
// the (16, C, n) limbs: for C columns of n rows of eight little-endian
// 32-bit words, optionally masked to 253 bits, each value times R^2 by a
// Montgomery product (x R mod p; mont_mul's result stays below 2p for any
// x below 2^256 when the other factor is below p, so rows at or above p
// decode to x mod p as well).  Beside the limbs, for each column, the
// maximum of each of the value's four 64-bit words and a flag for a row
// >= p (stats: 5 u64 a column, zeroed before the launch).
//
// Bound by bytes: 32 read and 64 written a value, against 264
// multiply-adds of the product.  The rows are value-major and the limbs
// limb-major, so a tile of DEC_TILE values turns in shared memory: the
// block reads the tile's 16-byte chunks coalesced (chunk q by thread q),
// each thread takes its value's two chunks from shared memory (chunk h of
// value i at 2i + (h ^ bit 2 of i): a quarter-warp's 16-byte reads and
// writes hit distinct banks), and each limb's store is coalesced across
// the threads.  blockIdx.y is the column, so a tile never straddles two;
// a block walks the column's tiles, keeps its threads' maxima in
// registers, and reduces them once at the end: a warp by shuffles, the
// block through shared memory, then one thread's five atomicMax.

constexpr int DEC_TILE = 256;
constexpr int DEC_MAX_BLOCKS = 132 * 8;
constexpr int DEC_STATS = 5;  // four word maxima and the >= p flag

struct DecodeConsts {
  uint32_t r2[NW];  // R^2 mod p, canonical words
};

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

template <int F>
__global__ void __launch_bounds__(DEC_TILE) decode_le32_kernel(
    const uint4* __restrict__ rows, uint32_t* __restrict__ out, int64_t n,
    int64_t total, uint32_t top_mask, DecodeConsts c,
    unsigned long long* __restrict__ stats) {
  __shared__ uint4 tile[2 * DEC_TILE];
  __shared__ unsigned long long part[DEC_TILE / 32][DEC_STATS];
  const int t = threadIdx.x;
  const int64_t col = blockIdx.y;
  Fe r2;
#pragma unroll
  for (int k = 0; k < NW; ++k) r2.w[k] = c.r2[k];
  unsigned long long mx[DEC_STATS] = {0, 0, 0, 0, 0};
  const int64_t tiles = (n + DEC_TILE - 1) / DEC_TILE;
#pragma unroll 1
  for (int64_t tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const int64_t first = col * n + tl * DEC_TILE;  // the tile's value 0
    const int64_t left = n - tl * DEC_TILE;
    const int count = left < DEC_TILE ? (int)left : DEC_TILE;
    __syncthreads();  // the previous tile's chunks are read
    for (int q = t; q < 2 * count; q += DEC_TILE) {
      const int i = q >> 1;
      tile[2 * i + ((q & 1) ^ ((i >> 2) & 1))] = rows[2 * first + q];
    }
    __syncthreads();
    if (t < count) {
      const int s = (t >> 2) & 1;
      const uint4 a = tile[2 * t + s], b = tile[2 * t + (s ^ 1)];
      Fe x;
      x.w[0] = a.x; x.w[1] = a.y; x.w[2] = a.z; x.w[3] = a.w;
      x.w[4] = b.x; x.w[5] = b.y; x.w[6] = b.z; x.w[7] = b.w & top_mask;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        mx[w] = umax64(mx[w], ((unsigned long long)x.w[2 * w + 1] << 32) |
                                  x.w[2 * w]);
      Fe d;
      if (!sub8(d, x, modulus<F>())) mx[4] = 1;  // no borrow: x >= p
      store_fe(out, total, first + t, mont_mul<F>(x, r2));
    }
  }
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int w = 0; w < DEC_STATS; ++w) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx[w] = umax64(mx[w], __shfl_down_sync(FULL_MASK, mx[w], off));
    if (lane == 0) part[warp][w] = mx[w];
  }
  __syncthreads();
  if (t < DEC_STATS) {
    unsigned long long v = 0;
#pragma unroll
    for (int k = 0; k < DEC_TILE / 32; ++k) v = umax64(v, part[k][t]);
    if (v) atomicMax(stats + DEC_STATS * col + t, v);
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

// steps: nsteps words of the schedule (PowSchedule), from
// cuda_ops.pow_schedule; first = -1 for e = 0
int h2_field_pow(int field, const void* a, long long a_ls, long long a_es,
                 void* out, long long n, const unsigned short* steps,
                 int nsteps, int first, int entries, void* stream) {
  if (n <= 0) return 0;
  if (nsteps < 0 || nsteps > POW_MAX_STEPS || entries < 1 ||
      entries > POW_MAX_ENTRIES || first >= entries)
    return (int)cudaErrorInvalidValue;
  PowSchedule sc;
  for (int k = 0; k < POW_MAX_STEPS; ++k)
    sc.step[k] = k < nsteps ? steps[k] : 0;
  for (int k = 0; k < nsteps; ++k)
    if ((int)(sc.step[k] & 15u) > entries) return (int)cudaErrorInvalidValue;
  sc.nsteps = nsteps;
  sc.first = first;
  sc.entries = entries;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  if (field == FR) {
    pow_kernel<FR><<<g, THREADS, 0, s>>>((const uint32_t*)a, a_ls, a_es,
                                         (uint32_t*)out, n, sc);
  } else if (field == FQ) {
    pow_kernel<FQ><<<g, THREADS, 0, s>>>((const uint32_t*)a, a_ls, a_es,
                                         (uint32_t*)out, n, sc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Resident blocks of THREADS threads a multiprocessor can hold for kernel
// `which` (0 pow on Fr, 1 pow on Fq), from the CUDA occupancy calculator.
int h2_field_occupancy(int which, int* blocks) {
  const void* fns[] = {(const void*)pow_kernel<FR>,
                       (const void*)pow_kernel<FQ>};
  if (which < 0 || which >= 2) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fns[which], THREADS, 0);
}

// p30, pinv30, r3, batches: InvConsts, from cuda_ops.inv_constants
int h2_field_inv(int field, const void* a, long long a_ls, long long a_es,
                 void* out, long long n, const int* p30, unsigned int pinv30,
                 const unsigned int* r3, int batches, void* stream) {
  if (n <= 0) return 0;
  if (batches < 0) return (int)cudaErrorInvalidValue;
  InvConsts c;
  for (int k = 0; k < S30_LIMBS; ++k) c.p30[k] = p30[k];
  c.pinv30 = pinv30;
  for (int k = 0; k < NW; ++k) c.r3[k] = r3[k];
  c.batches = batches;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  if (field == FR) {
    inv_kernel<FR><<<g, THREADS, 0, s>>>((const uint32_t*)a, a_ls, a_es,
                                         (uint32_t*)out, n, c);
  } else if (field == FQ) {
    inv_kernel<FQ><<<g, THREADS, 0, s>>>((const uint32_t*)a, a_ls, a_es,
                                         (uint32_t*)out, n, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a, out: pointers to logical element 0 (the last one for a reverse
// scan); per_thread: V, the run of each thread (1, 2, 4 or 8); state:
// 17 * tiles + 1 words, tiles = ceil(n / (SCAN_BLOCK * V))
int h2_scan(int field, int per_thread, const void* a, long long a_ls,
            long long a_es, void* out, long long o_ls, long long o_es,
            long long n, void* state, long long tiles, void* stream) {
  if (n <= 0) return 0;
  const int64_t tile = (int64_t)SCAN_BLOCK * per_thread;
  if (per_thread < 1 || tiles != (n + tile - 1) / tile || tiles > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* st = (uint32_t*)state;
  // the flags and the ticket counter
  const cudaError_t err = cudaMemsetAsync(st + 16 * tiles, 0,
                                          (tiles + 1) * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
#define H2_BY_V(F)                                                      \
  switch (per_thread) {                                                 \
    case 1: return launch_scan<F, 1>(a, a_ls, a_es, out, o_ls, o_es, n, \
                                     st, tiles, s);                     \
    case 2: return launch_scan<F, 2>(a, a_ls, a_es, out, o_ls, o_es, n, \
                                     st, tiles, s);                     \
    case 4: return launch_scan<F, 4>(a, a_ls, a_es, out, o_ls, o_es, n, \
                                     st, tiles, s);                     \
    case 8: return launch_scan<F, 8>(a, a_ls, a_es, out, o_ls, o_es, n, \
                                     st, tiles, s);                     \
    default: return (int)cudaErrorInvalidValue;                         \
  }
  if (field == FR) H2_BY_V(FR);
  if (field == FQ) H2_BY_V(FQ);
#undef H2_BY_V
  return (int)cudaErrorInvalidValue;
}

// rows: C * n rows of 32 bytes, 16-byte aligned; out: (16, C, n) words;
// top_mask: what word 7 of each row keeps (0x1FFFFFFF: 253 bits);
// r2: R^2 mod p, canonical words; stats: C * 5 u64, zeroed here, then
// each column's four word maxima and its >= p flag
int h2_decode_le32(int field, const void* rows, long long C, long long n,
                   unsigned int top_mask, const unsigned int* r2, void* out,
                   void* stats, void* stream) {
  if (C <= 0 || n < 0 || C > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      stats, 0, (size_t)C * DEC_STATS * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  DecodeConsts c;
  for (int k = 0; k < NW; ++k) c.r2[k] = r2[k];
  const int64_t tiles = (n + DEC_TILE - 1) / DEC_TILE;
  int64_t gx = (DEC_MAX_BLOCKS + C - 1) / C;
  if (gx > tiles) gx = tiles;
  const dim3 grid((unsigned)gx, (unsigned)C);
  const uint4* pr = (const uint4*)rows;
  uint32_t* po = (uint32_t*)out;
  unsigned long long* ps = (unsigned long long*)stats;
  if (field == FR) {
    decode_le32_kernel<FR><<<grid, DEC_TILE, 0, s>>>(pr, po, n, C * n,
                                                     top_mask, c, ps);
  } else if (field == FQ) {
    decode_le32_kernel<FQ><<<grid, DEC_TILE, 0, s>>>(pr, po, n, C * n,
                                                     top_mask, c, ps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
