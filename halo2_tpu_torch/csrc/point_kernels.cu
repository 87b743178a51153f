// G1 point kernels: one complete point operation per thread (add,
// add_mixed, double), the MSM scan step that takes its affine operand as
// packed words with a sign, the MSM's whole bucket scan of a window group
// (one thread a lane, the running sum in registers), the MSM's Horner
// combine over windows (a group of 8 threads a lane, one product a
// thread), the double-and-add ladder of a scalar multiplication (one
// thread a point), the fixed-base comb that multiplies the generator
// in the SRS setup (one thread a point), and the small MSM's buckets and
// their reduction (one block a window, one thread a bucket).  Coordinates are
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

// The MSM bucket scan of one window group: the whole of msm/sorted.py's
// per-group scan in one launch, where the reference launches the Pallas
// scan step (halo2_tpu/curves/pallas_point.py:73 _add_mixed_packed_call)
// once per step from a lax.scan (halo2_tpu/msm/sorted.py:144
// _prefix_scan_group).  One thread a lane (g, b): window g of the group,
// block b of its B blocks; the block covers the S = n / B sorted positions
// e = b*S + s, walked in order.  The running projective sum stays in
// registers.  At each step the thread reads the point's 64-byte row of the
// points-major packed table by the sort's order (two 16-bit limbs a word:
// words 0-7 x, 8-15 y), negates y where bit 0 of the sorted key is set,
// and makes the complete mixed add.
//
// It writes only what is read later: the lane's block total after S steps
// (tot, (16, G, B): the blocks' exclusive scan reads it), and, where a
// bucket ends (the next sorted digit differs, or the window's last
// position), the running sum and the block index into the slots of the
// (G, nb) table from its digit up to the next digit - 1 (nb - 1 at the
// window's end), so that slot j holds the prefix that ends at the last
// position whose digit is <= j.  Block 0's lane writes the slots below the
// window's first digit: the identity at block 0, whose exclusive prefix
// is the identity.  Digits are key >> 1 < nb; slots >= nb are never
// written.
//
// Bound by operations: 11 products and some 26 additions a position, on
// G * B lanes (49,152 at the k = 16 proof: 2.9 warps a scheduler), which
// reaches some 41 % of that bound on an H100 (PERF.md).  Of the forms
// measured it is the fastest: reading the next row before the add (more
// registers) and a pair of threads a lane (products split by level, warp
// shuffles, 80 registers with spills) were slower.  No carry goes through
// memory; the rows (64 bytes a point, read by G windows) mostly hit L2.
__global__ void __launch_bounds__(THREADS) msm_scan_kernel(
    const uint32_t* __restrict__ rows, const int64_t* __restrict__ order,
    const int32_t* __restrict__ key, int64_t n, int G, int B, int nb,
    uint32_t* __restrict__ tx, uint32_t* __restrict__ ty,
    uint32_t* __restrict__ tz, uint32_t* __restrict__ bx,
    uint32_t* __restrict__ by, uint32_t* __restrict__ bz,
    int32_t* __restrict__ blk) {
  const int64_t lanes = (int64_t)G * B;
  const int64_t S = n / B;
  const int64_t tab_n = (int64_t)G * nb;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < lanes; i += step) {
    const int64_t g = i / B;
    const int b = (int)(i - g * B);
    const int64_t* ord = order + g * n;
    const int32_t* ky = key + g * n;
    const int64_t tab0 = g * nb;
    Pt acc;                                   // the identity (0 : 1 : 0)
    acc.x = fe_zero();
    acc.y = one_mont<FQ>();
    acc.z = fe_zero();
    if (b == 0) {
      const int d0 = min(ky[0] >> 1, nb);
      for (int j = 0; j < d0; ++j) {
        store_pt(bx, by, bz, tab_n, tab0 + j, acc);
        blk[tab0 + j] = 0;
      }
    }
    const int64_t e0 = (int64_t)b * S;
    int32_t k = ky[e0];
    int64_t idx = ord[e0];
    for (int64_t e = e0; e < e0 + S; ++e) {
      const uint4* row = reinterpret_cast<const uint4*>(rows + idx * 16);
      const uint4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3];
      const bool last = e + 1 == n;
      const int32_t k_next = last ? nb << 1 : ky[e + 1];
      if (e + 1 < e0 + S) idx = ord[e + 1];
      Fe x2, y2;
      x2.w[0] = r0.x; x2.w[1] = r0.y; x2.w[2] = r0.z; x2.w[3] = r0.w;
      x2.w[4] = r1.x; x2.w[5] = r1.y; x2.w[6] = r1.z; x2.w[7] = r1.w;
      y2.w[0] = r2.x; y2.w[1] = r2.y; y2.w[2] = r2.z; y2.w[3] = r2.w;
      y2.w[4] = r3.x; y2.w[5] = r3.y; y2.w[6] = r3.z; y2.w[7] = r3.w;
      if (k & 1) y2 = neg_mod<FQ>(y2);
      acc = add_mixed(acc, x2, y2);
      const int d = k >> 1;
      const int d_next = min(k_next >> 1, nb);
      for (int j = d; j < d_next; ++j) {
        store_pt(bx, by, bz, tab_n, tab0 + j, acc);
        blk[tab0 + j] = b;
      }
      k = k_next;
    }
    store_pt(tx, ty, tz, lanes, i, acc);
  }
}

// The Horner combine over windows: acc = T[W-1]; for w = W-2 down to 0:
// c complete doublings, then a complete add of T[w]; then `tail` more
// doublings.  T[lane, w] of a coordinate sits at t + lane*lane_s +
// w*win_s, limb rows t_ls apart.  Stands for halo2_tpu/msm/msm.py:152
// _combine_windows (a lax.scan over windows) and, with W = 1, c = 0, for
// the M*E_M doublings of the Abel sum (halo2_tpu/msm/sorted.py:314).
//
// The chain is (W - 1)(c + 1) + tail dependent point operations and cannot
// get shorter, and a few lanes never fill the card, so each dependent step
// is made faster: a lane is a group of HG = 8 threads.  Every formula runs
// as curves/formulas.py's level schedule (double_levels, add_levels): two
// levels of independent products (4 and 4 for a doubling, 6 and 6 for an
// add), one product a thread, the products exchanged through shared
// memory, the additions between the levels made by every thread of the
// group.  Each field operation is one of the plain version's, and every
// result is canonical, so the projective limbs are equal.
constexpr int HG = 8;
constexpr int HLANES = THREADS / HG;   // lanes a block

struct Group {
  Fe (*buf)[2][HG];   // this lane's exchange slots, double-buffered
  unsigned mask;      // the group's threads in the warp
  int r;              // this thread's role, 0..HG-1
  int parity;
};

// Publishes this thread's product v; returns the HG products of the
// group's threads.  Two buffers in turn: a thread writes a buffer again
// only after the next exchange's barrier, which every thread of the group
// reaches after its reads of this one.
__device__ __forceinline__ const Fe* exchange(Group& gr, const Fe& v) {
  Fe* slots = (*gr.buf)[gr.parity];
  gr.parity ^= 1;
  slots[gr.r] = v;
  __syncwarp(gr.mask);
  return slots;
}

// by value: a reference to one of four locals would put them on the stack
__device__ __forceinline__ Fe pick4(int q, const Fe& a, const Fe& b,
                                    const Fe& c, const Fe& d) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    r.w[k] = q == 0 ? a.w[k] : q == 1 ? b.w[k] : q == 2 ? c.w[k] : d.w[k];
  return r;
}

// formulas.py double_levels (RCB15 algorithm 9)
__device__ __forceinline__ Pt double_grouped(Group& gr, const Pt& p) {
  const int q = gr.r & 3;
  const Fe* l1 = exchange(gr, fq_mul(pick4(q, p.y, p.y, p.z, p.x),
                                     pick4(q, p.y, p.z, p.z, p.y)));
  Fe t0 = l1[0];
  const Fe t1 = l1[1];
  Fe t2 = mul_by_9(l1[2]);
  const Fe xy = l1[3];
  Fe z3 = fq_add(t0, t0);
  z3 = fq_add(z3, z3);
  z3 = fq_add(z3, z3);
  const Fe y3 = fq_add(t0, t2);
  const Fe t2x3 = fq_add(fq_add(t2, t2), t2);
  t0 = fq_sub(t0, t2x3);
  const Fe* l2 = exchange(gr, fq_mul(pick4(q, t2, t1, t0, t0),
                                     pick4(q, z3, z3, y3, xy)));
  Pt r;
  r.x = fq_add(l2[3], l2[3]);
  r.y = fq_add(l2[0], l2[2]);
  r.z = l2[1];
  return r;
}

// formulas.py add_levels (RCB15 algorithm 7)
__device__ __forceinline__ Pt add_grouped(Group& gr, const Pt& p,
                                          const Pt& t) {
  const int q = gr.r < 6 ? gr.r : gr.r - 6;
  Fe a, b;
  switch (q) {
    case 0: a = p.x; b = t.x; break;
    case 1: a = p.y; b = t.y; break;
    case 2: a = p.z; b = t.z; break;
    case 3: a = fq_add(p.x, p.y); b = fq_add(t.x, t.y); break;
    case 4: a = fq_add(p.y, p.z); b = fq_add(t.y, t.z); break;
    default: a = fq_add(p.x, p.z); b = fq_add(t.x, t.z); break;
  }
  const Fe* l1 = exchange(gr, fq_mul(a, b));
  Fe t0 = l1[0];
  Fe t1 = l1[1];
  Fe t2 = l1[2];
  const Fe t3 = fq_sub(l1[3], fq_add(t0, t1));
  const Fe t4 = fq_sub(l1[4], fq_add(t1, t2));
  Fe y3 = fq_sub(l1[5], fq_add(t0, t2));
  t0 = fq_add(fq_add(t0, t0), t0);
  t2 = mul_by_9(t2);
  const Fe z3 = fq_add(t1, t2);
  t1 = fq_sub(t1, t2);
  y3 = mul_by_9(y3);
  switch (q) {
    case 0: a = t4; b = y3; break;
    case 1: a = t3; b = t1; break;
    case 2: a = y3; b = t0; break;
    case 3: a = t1; b = z3; break;
    case 4: a = t0; b = t3; break;
    default: a = z3; b = t4; break;
  }
  const Fe* l2 = exchange(gr, fq_mul(a, b));
  Pt r;
  r.x = fq_sub(l2[1], l2[0]);
  r.y = fq_add(l2[3], l2[2]);
  r.z = fq_add(l2[5], l2[4]);
  return r;
}

__device__ __forceinline__ Pt load_window(const uint32_t* tx,
                                          const uint32_t* ty,
                                          const uint32_t* tz, int64_t t_ls,
                                          int64_t at) {
  Pt p;
  p.x = load_fe(tx, t_ls, at);
  p.y = load_fe(ty, t_ls, at);
  p.z = load_fe(tz, t_ls, at);
  return p;
}

__global__ void __launch_bounds__(THREADS) point_horner_kernel(
    const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
    const uint32_t* __restrict__ tz, int64_t t_ls, int64_t lane_s,
    int64_t win_s, int64_t lanes, int W, int c, int tail,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz) {
  __shared__ Fe xch[HLANES][2][HG];
  const int slot = threadIdx.x / HG;
  Group gr;
  gr.buf = &xch[slot];
  gr.mask = 0xFFu << (threadIdx.x % 32 / HG * HG);
  gr.r = threadIdx.x % HG;
  gr.parity = 0;
  const int64_t step = (int64_t)gridDim.x * HLANES;
  // every thread of a group takes the same lanes, so the group stays whole
  for (int64_t i = (int64_t)blockIdx.x * HLANES + slot; i < lanes;
       i += step) {
    const int64_t base = i * lane_s;
    Pt acc = load_window(tx, ty, tz, t_ls, base + (int64_t)(W - 1) * win_s);
    for (int w = W - 2; w >= 0; --w) {
      const Pt t = load_window(tx, ty, tz, t_ls, base + (int64_t)w * win_s);
      for (int k = 0; k < c; ++k) acc = double_grouped(gr, acc);
      acc = add_grouped(gr, acc, t);
    }
    for (int k = 0; k < tail; ++k) acc = double_grouped(gr, acc);
    if (gr.r == 0) store_pt(ox, oy, oz, lanes, i, acc);
  }
}

// k_i * P_i for affine P_i (never the identity) and standard-form scalar
// limbs: over the 256 bits, least significant first, acc += base where the
// bit is set, then base = 2 * base (not after the last bit).  One thread a
// point.  Stands for halo2_tpu/curves/g1.py:141 scalar_mul (a lax.scan
// over the bits); the same sequence of complete formulas as the plain
// version, so the projective limbs are equal.  No driven path runs it:
// setup multiplies the generator only, by fixed_base_kernel.  Bound by
// operations: up to
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

// k_i * G for the one affine base G of a fixed-base table and
// standard-form scalar limbs: the comb of windows of c = 8 bits (the
// reference's own fixed-base method, halo2_tpu/curves/host.py
// fixed_base_mul, which its setup runs on the CPU).  Row w * 256 + d of
// `tab` is the affine point d * 2^(8w) * G as 16 packed words (two 16-bit
// limbs a word, words 0-7 x, 8-15 y; row d = 0 of each window is never
// used); 32 windows, 8,192 rows, 512 KiB, which stay in L2.  One thread a
// point: from the identity, for w = 0..31, acc = add_mixed(acc, T[w][d_w])
// where byte w of the scalar d_w is not 0; a select keeps acc where it is.
// The same sequence of complete formulas as g1.plain_fixed_base_mul, so
// the projective limbs are equal.  It replaces the double-and-add ladder
// (point_ladder_kernel) in Params.unsafe_setup: 32 mixed adds a point, no
// doublings, against 255 doublings and up to 256 adds.  Each thread reads
// its 64-byte row of a window straight from L2 (two sectors, all of them
// used); bound by operations: 11 products of 264 integer multiply-adds and
// 25 additions a window, on 64 bytes in and 192 out a point.
__global__ void __launch_bounds__(THREADS) fixed_base_kernel(
    const uint4* __restrict__ tab, const uint32_t* __restrict__ s,
    int64_t s_ls, int64_t s_es, uint32_t* __restrict__ ox,
    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Pt acc;                                   // the identity (0 : 1 : 0)
    acc.x = fe_zero();
    acc.y = one_mont<FQ>();
    acc.z = fe_zero();
#pragma unroll 1
    for (int w = 0; w < 2 * NL; ++w) {
      const uint32_t limb = s[(int64_t)(w >> 1) * s_ls + i * s_es];
      const uint32_t d = (limb >> (8 * (w & 1))) & 0xFFu;
      const uint4* row = tab + (int64_t)(w * 256 + d) * 4;
      const uint4 r0 = __ldg(row), r1 = __ldg(row + 1);
      const uint4 r2 = __ldg(row + 2), r3 = __ldg(row + 3);
      Fe x2, y2;
      x2.w[0] = r0.x; x2.w[1] = r0.y; x2.w[2] = r0.z; x2.w[3] = r0.w;
      x2.w[4] = r1.x; x2.w[5] = r1.y; x2.w[6] = r1.z; x2.w[7] = r1.w;
      y2.w[0] = r2.x; y2.w[1] = r2.y; y2.w[2] = r2.z; y2.w[3] = r2.w;
      y2.w[4] = r3.x; y2.w[5] = r3.y; y2.w[6] = r3.z; y2.w[7] = r3.w;
      const Pt sum = add_mixed(acc, x2, y2);
      if (d != 0) acc = sum;
    }
    store_pt(ox, oy, oz, n, i, acc);
  }
}

// The small-MSM bucket path: for each row r (a window of 8 bits of a
// column), T_r = sum_{b >= 1} b * B_{r,b}, where B_{r,b} is the sum of the
// affine points P_i whose digit d_{r,i} is b.  One launch stands for the
// reference's whole bucket path below 2048 points: its lax.scan of mixed
// adds into lane-private buckets (halo2_tpu/msm/msm.py:54 _accumulate),
// the lane merge (:113 _merge_lanes) and the reduction (:118
// _reduce_buckets).  The reference keeps one bucket column a lane so that
// its scatter never conflicts; here one block takes a row and sorts its
// points by digit in shared memory (a histogram, the buckets' starts, a
// scatter of digit and index), so every bucket is one run of a sorted
// list and the lanes are merged as the points are added.
//
// What bounds it on an H100: at the reference's sizes (n < 2048 points,
// 32-160 rows) a row's chain of dependent point operations.  A one-thread
// complete add is some 14 us of dependent products on a SM with one row
// (27,000 cycles: radix round 1 at n = 2047); a group of 8 threads makes
// one in two levels of products (the Horner kernel's add_grouped) in some
// 4 us; where two rows share a SM, their multiply-adds count too.  The
// design (PERF.md; clock64 cycles a phase by
// examples/torch_bucket_probe.py --variants):
//
// 1. The fill is balanced by points, not by buckets.  Of the M listed
//    points of a chunk, thread t takes the L = ceil(M / T) positions from
//    t L on, whatever their buckets, and sums them in registers piece by
//    piece, a piece being the positions of one bucket inside the run (its
//    first point is taken as (x, y, 1): no add).  A piece that holds its
//    whole bucket goes to the bucket's slot.  Only a run's first and last
//    piece can share a bucket with other runs: the last pieces form chains
//    of threads, summed by a segmented Hillis-Steele scan over the threads
//    for as many rounds as the longest chain needs (none where no bucket
//    crosses a run); the thread where a bucket ends writes it, and a first
//    piece whose bucket began earlier (in its slot) takes its
//    predecessor's chain sum.  The crowded top window of a 254-bit scalar
//    (digits up to 0x30: some 42 points a bucket at n = 2047) costs its
//    row L mixed adds a thread and three rounds, not one thread's 42 adds.
// 2. The reduction does about the running sum's work in 18 steps: with
//    b = 16 h + l, sum_b b B_b = 16 sum_h h C_h + sum_l l D_l, where C_h =
//    sum_l B_{16h+l} and D_l = sum_h B_{16h+l}.  The 30 sums of 16 (C_0
//    and D_0 have weight 0) take 450 adds in 4 pairwise rounds (256, 128,
//    64, 32 adds: the first two a thread an add, the rest a group of 8
//    threads an add).  Then the 8 bit planes F_j = sum of the D_l (j < 4)
//    or C_h (j >= 4) whose bit j & 3 is set, each a sum of 8 in 3 rounds
//    (56 adds), and sum_j 2^j F_j by a tree: F_2k + 2 F_2k+1, then x + 4 y,
//    then x + 16 y (12 doublings, 7 deep; 7 adds).  513 complete adds a
//    dense row, against some 2,050 of the suffix scan and halving tree this
//    kernel ran before.  An add with the identity on either side is
//    skipped, which keeps the sparse rows of a small n cheap.
// 3. The rows spread over the card: a block of T = 256 threads a row where
//    the rows fit the SMs one a SM, of T = 128 where there are more rows
//    than SMs (the golden K = 9 batch: 160 rows), two of which fit a SM
//    (198 registers, 75 KiB of shared memory each), so every row starts at
//    once.  The point operations are calls (add_any, add_point, the
//    grouped ones), and a one-thread add makes two independent products a
//    call (fq_mul2, formulas.py's levels).
//
// Measured on an H100 and dropped (examples/torch_bucket_probe.py
// --variants, device ms of the golden batch / n = 16 / n = 2047 against
// 0.1760 / 0.0710 / 0.2165 kept): blocks of 256 threads at every row count
// 0.2541 (160 rows in two waves) / 0.0716 / 0.2181; the same under
// __launch_bounds__(256, 2), 128 registers and 244 bytes of spills, 0.2343
// / 0.0851 / 0.2552; one product a call (fq_mul alone) 0.1886 / 0.0783 /
// 0.2309; blocks of 128 at every row count 0.1775 / 0.0736 / 0.2513
// (another call, 0.1777 / 0.0697 / 0.2171 kept).  A cluster of blocks a
// row (partials through distributed shared memory) was not built: a
// row's time is its dependent chain, which more SMs do not shorten, and
// 160 rows already fill the SMs.
//
// The projective limbs differ from the plain version's (the adds follow
// the sort's atomics and another tree); the group element, and so the
// affine point, is the same.  Shared memory: the bucket slots and the
// chains' slots (two 256-entry coordinate arrays, 48 KiB, which the
// reduction's rounds also use in turn), the groups' exchange (16 KiB), the
// sorted list of a chunk (8 KiB): 75 KiB, dynamic.
constexpr int NB = 256;               // buckets of a window (c = 8)
constexpr int BUCKET_CHUNK = 2048;    // point indices sorted at a time
constexpr int BGROUPS = NB / HG;      // groups of HG threads, at most

struct BucketSmem {
  Fe sx[NB], sy[NB], sz[NB];          // the buckets; then rounds 2, 4, ...
  Fe vx[NB], vy[NB], vz[NB];          // the chains; then rounds 1, 3, ...
  Fe xch[BGROUPS][2][HG];             // the groups' product exchange
  int list[BUCKET_CHUNK];             // (digit << 16) | index, by digit
  int count[NB];
  int start[NB + 1];                  // bucket b: list[start[b], start[b+1])
  int cursor[NB];
  int span;                           // the longest chain, in threads
};

// Two independent Montgomery products over Fq in one call, their CIOS
// rows interleaved so that each chain of dependent multiply-adds fills the
// other's latency: a one-thread point formula otherwise waits on one
// product at a time, and at the few warps a bucket block keeps on an SM
// the latency of the products, not the multiply-add rate, sets its pace.
// Not inlined (one copy of the body, operands and results in registers),
// as fq_mul.
struct Fe2 {
  Fe a, b;
};

__device__ __noinline__ Fe2 fq_mul2(Fe a1, Fe b1, Fe a2, Fe b2) {
  uint32_t t[NW + 2], u[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; ++k) t[k] = u[k] = 0;
  const Fe p = modulus<FQ>();
  const uint32_t inv = MONT_INV[FQ];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    mad_row(t, a1, b1.w[i]);
    mad_row(u, a2, b2.w[i]);
    const uint32_t mt = t[0] * inv, mu = u[0] * inv;
    mad_row(t, p, mt);
    mad_row(u, p, mu);
#pragma unroll
    for (int k = 0; k < NW + 1; ++k) {
      t[k] = t[k + 1];
      u[k] = u[k + 1];
    }
    t[NW + 1] = u[NW + 1] = 0;
  }
  Fe2 r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    r.a.w[k] = t[k];
    r.b.w[k] = u[k];
  }
  r.a = cond_sub_p<FQ>(r.a);
  r.b = cond_sub_p<FQ>(r.b);
  return r;
}

// The second level of the add formulas (formulas.py add_levels), from the
// first level's results: 6 products in three fq_mul2 calls.
__device__ __forceinline__ Pt add_level2(Fe t0, Fe t1, Fe t2, const Fe& t3,
                                         const Fe& t4, Fe y3) {
  t0 = fq_add(fq_add(t0, t0), t0);
  t2 = mul_by_9(t2);
  const Fe z3 = fq_add(t1, t2);
  t1 = fq_sub(t1, t2);
  y3 = mul_by_9(y3);
  const Fe2 d = fq_mul2(t4, y3, t3, t1);
  const Fe2 e = fq_mul2(y3, t0, t1, z3);
  const Fe2 f = fq_mul2(t0, t3, z3, t4);
  Pt r;
  r.x = fq_sub(d.b, d.a);
  r.y = fq_add(e.b, e.a);
  r.z = fq_add(f.b, f.a);
  return r;
}

// add_complete (RCB15 algorithm 7) by one thread as two levels of 6
// independent products, each level three fq_mul2 calls: the same field
// operations as add_complete, so the same result.
__device__ __forceinline__ Pt add_complete_ilp(const Pt& p, const Pt& q) {
  const Fe2 a = fq_mul2(p.x, q.x, p.y, q.y);
  const Fe2 b = fq_mul2(p.z, q.z, fq_add(p.x, p.y), fq_add(q.x, q.y));
  const Fe2 c = fq_mul2(fq_add(p.y, p.z), fq_add(q.y, q.z),
                        fq_add(p.x, p.z), fq_add(q.x, q.z));
  return add_level2(a.a, a.b, b.a, fq_sub(b.b, fq_add(a.a, a.b)),
                    fq_sub(c.a, fq_add(a.b, b.a)),
                    fq_sub(c.b, fq_add(a.a, b.a)));
}

// add_mixed (RCB15 algorithm 8) by one thread: 5 products (two fq_mul2,
// one fq_mul), then add_complete_ilp's second level with t2 = z1 (its
// first level's t2 = z1 * z2, z2 = 1)
__device__ __forceinline__ Pt add_mixed_ilp(const Pt& p, const Fe& x2,
                                            const Fe& y2) {
  const Fe2 a = fq_mul2(p.x, x2, p.y, y2);
  const Fe2 b = fq_mul2(fq_add(x2, y2), fq_add(p.x, p.y), y2, p.z);
  const Fe y3 = fq_add(fq_mul(x2, p.z), p.x);
  return add_level2(a.a, a.b, p.z, fq_sub(b.a, fq_add(a.a, a.b)),
                    fq_add(b.b, p.y), y3);
}

__device__ __forceinline__ Pt identity() {    // (0 : 1 : 0)
  Pt p;
  p.x = fe_zero();
  p.y = one_mont<FQ>();
  p.z = fe_zero();
  return p;
}

// The kernel's point operations, each a call (not inlined): the kernel
// body keeps few values live across one, so that it and the formulas fit
// the 128 registers of two blocks a SM without spilling.  An operand that
// is the identity is skipped (the other operand is the sum), which keeps
// the sparse rows of a small n cheap.
__device__ __noinline__ Pt add_any(Pt p, Pt q) {        // one thread
  if (fe_is_zero(q.z)) return p;
  if (fe_is_zero(p.z)) return q;
  return add_complete_ilp(p, q);
}

__device__ __noinline__ Pt add_point(Pt p, Fe x, Fe y) {  // one thread
  return add_mixed_ilp(p, x, y);
}

// A group of HG threads, all with the same operands; the group is passed
// by value: a formula's two exchanges leave its parity as they found it.
__device__ __noinline__ Pt add_any_grouped(Group gr, Pt p, Pt q) {
  if (fe_is_zero(q.z)) return p;
  if (fe_is_zero(p.z)) return q;
  return add_grouped(gr, p, q);
}

// 2^k p
__device__ __noinline__ Pt times_2k_grouped(Group gr, Pt p, int k) {
  if (fe_is_zero(p.z)) return p;
  for (int i = 0; i < k; ++i) p = double_grouped(gr, p);
  return p;
}

__device__ __forceinline__ void put_slot(Fe* sx, Fe* sy, Fe* sz, int b,
                                         const Pt& p) {
  sx[b] = p.x;
  sy[b] = p.y;
  sz[b] = p.z;
}

__device__ __forceinline__ Pt get_slot(const Fe* sx, const Fe* sy,
                                       const Fe* sz, int b) {
  Pt p;
  p.x = sx[b];
  p.y = sy[b];
  p.z = sz[b];
  return p;
}

// The operands (u, w) of add `item` of a radix round of `half` adds a side
// (128, 64, 32, 16), whose result goes to slot `item`: items below `half`
// pair the row sums (2i, 2i + 1); the others, q = item - half, pair the
// column sums of rows 2k and 2k + 1 (k = q >> 4, l = q & 15), laid out 16
// a row from slot `d_in` on (the buckets themselves in round 1).
__device__ __forceinline__ void radix_pair(int half, int d_in, int item,
                                           int& u, int& w) {
  if (item < half) {
    u = 2 * item;
    w = u + 1;
  } else {
    const int q = item - half;
    u = d_in + 32 * (q >> 4) + (q & 15);
    w = u + 16;
  }
}

// the k-th (0..7) of the 16 indices whose bit j is set
__device__ __forceinline__ int with_bit(int k, int j) {
  return ((k >> j) << (j + 1)) | (1 << j) | (k & ((1 << j) - 1));
}

__global__ void __launch_bounds__(NB) msm_bucket_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const int32_t* __restrict__ digits, int64_t n, int rows,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz) {
  extern __shared__ __align__(16) unsigned char bucket_smem[];
  BucketSmem& sm = *reinterpret_cast<BucketSmem*>(bucket_smem);
  Fe* const sx = sm.sx;
  Fe* const sy = sm.sy;
  Fe* const sz = sm.sz;
  Fe* const vx = sm.vx;
  Fe* const vy = sm.vy;
  Fe* const vz = sm.vz;
  const int t = threadIdx.x;
  const int T = blockDim.x;                   // 128 or 256
  const int K = NB / T;                       // buckets a thread
  const int g = t / HG;
  const int G = T / HG;                       // groups
  Group gr;
  gr.buf = &sm.xch[g];
  gr.mask = 0xFFu << (t % 32 / HG * HG);
  gr.r = t % HG;
  gr.parity = 0;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int32_t* dig = digits + (int64_t)r * n;
    for (int b = t; b < NB; b += T) put_slot(sx, sy, sz, b, identity());
    for (int64_t c0 = 0; c0 < n; c0 += BUCKET_CHUNK) {
      const int m = (int)min((int64_t)BUCKET_CHUNK, n - c0);
      for (int b = t; b < NB; b += T) sm.count[b] = 0;
      if (t == 0) sm.span = 1;
      __syncthreads();
      for (int i = t; i < m; i += T) {
        const int d = dig[c0 + i] & (NB - 1);
        if (d) atomicAdd(&sm.count[d], 1);
      }
      __syncthreads();
      // the buckets' starts: thread t sums its K buckets t K .. t K + K - 1,
      // a Hillis-Steele scan over the threads, then their starts in turn
      int mine = 0;
      for (int j = 0; j < K; ++j) mine += sm.count[t * K + j];
      sm.cursor[t] = mine;
      __syncthreads();
      for (int s = 1; s < T; s <<= 1) {
        const int v = t >= s ? sm.cursor[t - s] : 0;
        __syncthreads();
        sm.cursor[t] += v;
        __syncthreads();
      }
      int run = sm.cursor[t] - mine;
      __syncthreads();
      for (int j = 0; j < K; ++j) {
        const int b = t * K + j;
        sm.start[b] = sm.cursor[b] = run;     // the scatter's cursor
        run += sm.count[b];
      }
      if (t == T - 1) sm.start[NB] = run;
      __syncthreads();
      for (int i = t; i < m; i += T) {
        const int d = dig[c0 + i] & (NB - 1);
        if (d) sm.list[atomicAdd(&sm.cursor[d], 1)] = (d << 16) | i;
      }
      __syncthreads();
      // the fill: thread t sums the listed positions [a, e), runs of
      // L = ceil(M / T), piece by piece
      const int M = sm.start[NB];
      const int L = (M + T - 1) / T;
      const int a = min(t * L, M), e = min(a + L, M);
      Pt part = identity();                   // the open piece
      int pb = 0;                             // its bucket (0: none yet)
      int hb = 0;                             // a first piece's bucket that
                                              // began before a, ends here
      for (int j = a; j < e; ++j) {
        const int w = sm.list[j];
        const int d = w >> 16;
        const int64_t i = c0 + (w & 0xFFFF);
        const Fe x = load_fe(px, n, i);
        const Fe y = load_fe(py, n, i);
        if (d != pb) {
          if (pb) {                           // bucket pb ends inside the run
            if (sm.start[pb] < a) hb = pb;
            put_slot(sx, sy, sz, pb,
                     add_any(get_slot(sx, sy, sz, pb), part));
          }
          part.x = x;
          part.y = y;
          part.z = one_mont<FQ>();
          pb = d;
        } else {
          part = add_point(part, x, y);
        }
      }
      // the chains: thread t carries its last piece's bucket pb from the
      // thread `first` whose run holds that bucket's first point
      const int first = pb && sm.start[pb] < a ? sm.start[pb] / L : t;
      if (first < t) atomicMax(&sm.span, t - first + 1);
      put_slot(vx, vy, vz, t, part);
      __syncthreads();
      const int span = sm.span;
      for (int s = 1; s < span; s <<= 1) {
        const bool take = t - s >= first;
        Pt o;
        if (take) o = get_slot(vx, vy, vz, t - s);
        __syncthreads();
        if (take) {
          part = add_any(part, o);
          put_slot(vx, vy, vz, t, part);
        }
        __syncthreads();
      }
      // a bucket that ends with the run is whole in this thread's chain
      if (a < e && sm.start[pb + 1] == e)
        put_slot(sx, sy, sz, pb,
                 add_any(get_slot(sx, sy, sz, pb), part));
      // a first piece (in its slot) takes the chain of the runs before it
      if (hb)
        put_slot(sx, sy, sz, hb,
                 add_any(get_slot(sx, sy, sz, hb),
                                   get_slot(vx, vy, vz, t - 1)));
      __syncthreads();                        // the list, chains, buckets
    }
    // the reduction; rounds 1 and 2 a thread an add (round 1 skips C_0's
    // and D_0's sums: weight 0)
    for (int it = t; it < NB; it += T) {
      int u, w;
      radix_pair(NB / 2, 0, it, u, w);
      const bool used = it < NB / 2 ? it >= 8 : (it & 15) != 0;
      Pt s = identity();
      if (used) s = add_any(get_slot(sx, sy, sz, u), get_slot(sx, sy, sz, w));
      put_slot(vx, vy, vz, it, s);
    }
    __syncthreads();
    for (int it = t; it < NB / 2; it += T) {
      int u, w;
      radix_pair(NB / 4, NB / 2, it, u, w);
      put_slot(sx, sy, sz, it,
               add_any(get_slot(vx, vy, vz, u), get_slot(vx, vy, vz, w)));
    }
    __syncthreads();
    // rounds 3 (64 adds) and 4 (32) by groups of 8 threads
    for (int it = g; it < NB / 4; it += G) {
      int u, w;
      radix_pair(NB / 8, NB / 4, it, u, w);
      const Pt s = add_any_grouped(gr, get_slot(sx, sy, sz, u),
                                   get_slot(sx, sy, sz, w));
      if (gr.r == 0) put_slot(vx, vy, vz, it, s);
    }
    __syncthreads();
    for (int it = g; it < NB / 8; it += G) {
      int u, w;
      radix_pair(NB / 16, NB / 8, it, u, w);
      const Pt s = add_any_grouped(gr, get_slot(vx, vy, vz, u),
                                   get_slot(vx, vy, vz, w));
      if (gr.r == 0) put_slot(sx, sy, sz, it, s);
    }
    __syncthreads();
    // C_h in slots 0..15, D_l in 16..31.  The bit planes: plane j (0..7)
    // sums the 8 D_l (j < 4) or C_h (j >= 4) whose bit j & 3 is set; a
    // group a pair, then 16 and 8 adds
    for (int it = g; it < 32; it += G) {
      const int plane = it >> 2, p = it & 3;
      const int base = plane < 4 ? 16 : 0;
      const Pt s = add_any_grouped(
          gr, get_slot(sx, sy, sz, base + with_bit(2 * p, plane & 3)),
          get_slot(sx, sy, sz, base + with_bit(2 * p + 1, plane & 3)));
      if (gr.r == 0) put_slot(vx, vy, vz, it, s);
    }
    __syncthreads();
    if (g < 16) {                             // G >= 16
      const Pt s = add_any_grouped(gr, get_slot(vx, vy, vz, 2 * g),
                                   get_slot(vx, vy, vz, 2 * g + 1));
      if (gr.r == 0) put_slot(sx, sy, sz, g, s);
    }
    __syncthreads();
    if (g < 8) {
      const Pt s = add_any_grouped(gr, get_slot(sx, sy, sz, 2 * g),
                                   get_slot(sx, sy, sz, 2 * g + 1));
      if (gr.r == 0) put_slot(vx, vy, vz, g, s);
    }
    __syncthreads();
    // sum_j 2^j F_j: F_2k + 2 F_2k+1, then x + 4 y, then x + 16 y
    if (g < 4) {
      const Pt hi = times_2k_grouped(gr, get_slot(vx, vy, vz, 2 * g + 1), 1);
      const Pt s = add_any_grouped(gr, get_slot(vx, vy, vz, 2 * g), hi);
      if (gr.r == 0) put_slot(sx, sy, sz, g, s);
    }
    __syncthreads();
    if (g < 2) {
      const Pt hi = times_2k_grouped(gr, get_slot(sx, sy, sz, 2 * g + 1), 2);
      const Pt s = add_any_grouped(gr, get_slot(sx, sy, sz, 2 * g), hi);
      if (gr.r == 0) put_slot(vx, vy, vz, g, s);
    }
    __syncthreads();
    if (g == 0) {
      const Pt hi = times_2k_grouped(gr, get_slot(vx, vy, vz, 1), 4);
      const Pt s = add_any_grouped(gr, get_slot(vx, vy, vz, 0), hi);
      if (gr.r == 0) store_pt(ox, oy, oz, rows, r, s);
    }
    __syncthreads();                          // the slots of the next row
  }
}

}  // namespace

extern "C" {

// msm_bucket_kernel's shared memory is dynamic (above the 48 KiB of a
// static allocation); the attribute that allows it is set once a process
static int bucket_smem_attr() {
  static const int err = (int)cudaFuncSetAttribute(
      msm_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(BucketSmem));
  return err;
}

// Resident blocks a multiprocessor can hold for kernel `which` (0 add,
// 1 add_mixed, 2 double, 3 add_mixed_packed, 4 horner, 5 ladder,
// 6 msm_scan, 7 fixed_base: blocks of THREADS threads; 8 and 9
// msm_bucket: of NB and NB / 2, with its dynamic shared memory), from the
// CUDA occupancy calculator.
int h2_point_occupancy(int which, int* blocks) {
  const void* fns[] = {(const void*)point_add_kernel,
                       (const void*)point_add_mixed_kernel,
                       (const void*)point_double_kernel,
                       (const void*)add_mixed_packed_kernel,
                       (const void*)point_horner_kernel,
                       (const void*)point_ladder_kernel,
                       (const void*)msm_scan_kernel,
                       (const void*)fixed_base_kernel,
                       (const void*)msm_bucket_kernel,
                       (const void*)msm_bucket_kernel};
  if (which < 0 || which >= 10) return (int)cudaErrorInvalidValue;
  const bool bucket = which >= 8;
  if (bucket && bucket_smem_attr() != 0) return bucket_smem_attr();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fns[which], bucket ? NB >> (which - 8) : THREADS,
      bucket ? sizeof(BucketSmem) : 0);
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
  point_horner_kernel<<<grid_for(lanes * HG), THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)tx, (const uint32_t*)ty, (const uint32_t*)tz, t_ls,
      lane_s, win_s, lanes, W, c, tail, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz);
  return (int)cudaGetLastError();
}

// rows (points, 16) packed, 16-byte aligned; order (G, n) int64 and key
// (G, n) int32 sorted per window; n a multiple of B; outputs tot (16, G, B)
// x 3, tab (16, G, nb) x 3, blk (G, nb).
int h2_msm_scan(const void* rows, const void* order, const void* key,
                long long n, int G, int B, int nb, void* tx, void* ty,
                void* tz, void* bx, void* by, void* bz, void* blk,
                void* stream) {
  if (G <= 0 || n <= 0) return 0;
  if (B < 1 || n % B != 0 || nb < 1) return (int)cudaErrorInvalidValue;
  msm_scan_kernel<<<grid_for((int64_t)G * B), THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int64_t*)order, (const int32_t*)key, n,
      G, B, nb, (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz, (uint32_t*)bx,
      (uint32_t*)by, (uint32_t*)bz, (int32_t*)blk);
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

// tab: (8192, 16) packed rows, 16-byte aligned (see fixed_base_kernel);
// s: standard-form scalar limbs, limb stride s_ls, element stride s_es
int h2_fixed_base(const void* tab, const void* s, long long s_ls,
                  long long s_es, void* ox, void* oy, void* oz, long long n,
                  void* stream) {
  if (n <= 0) return 0;
  fixed_base_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)tab, (const uint32_t*)s, s_ls, s_es, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

// px, py (16, n) affine limbs; digits (rows, n) int32 in [0, 256);
// outputs (16, rows) x 3, the rows' totals.  A block of 256 threads a row
// where the rows fit the SMs one a SM; where there are more rows than SMs,
// blocks of 128, two of which fit a SM (registers, shared memory), so that
// every row starts at once.
int h2_msm_bucket(const void* px, const void* py, const void* digits,
                  long long n, int rows, void* ox, void* oy, void* oz,
                  void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (bucket_smem_attr() != 0) return bucket_smem_attr();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = rows < MAX_BLOCKS ? rows : MAX_BLOCKS;
  msm_bucket_kernel<<<grid, rows > sms ? NB / 2 : NB, sizeof(BucketSmem),
                      (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const int32_t*)digits, n,
      rows, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}

}  // extern "C"
