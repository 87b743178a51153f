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
// _reduce_buckets).
//
// One block a row, one thread a bucket (thread b owns bucket b; bucket 0
// is the discard bucket and takes nothing).  The reference keeps one
// bucket column a lane so that its scatter never conflicts; here the
// block sorts the row's points by digit in shared memory instead (a
// histogram, its scan, a scatter of the point indices), so every thread
// walks its own bucket's list and mixed-adds those points into the
// running sum in its registers: no conflict, no atomics on points, and
// the lanes of a warp run the same formula side by side.  The points come
// in chunks of BUCKET_CHUNK.  Lanes are thus merged as they are
// accumulated: a bucket sums every share of the points.
//
// Then the reduction, in shared memory (three 256-entry coordinate
// arrays, 24 KiB): a Hillis-Steele suffix scan S_b = sum_{j >= b} B_j (8
// rounds), slot 0 set to the identity, and a halving tree sum of S_1 ..
// S_255 (8 rounds): sum_{b >= 1} S_b = sum_b b * B_b.  A complete add with
// the identity on either side is skipped (the other operand is the sum),
// which saves the sparse rows of a small n most of their adds.  The
// projective limbs differ from the plain version's (the order of the adds
// within a bucket follows the atomics of the scatter); the group element,
// and so the affine point, is the same.
//
// Bound by operations: a mixed add for every non-zero digit and the
// reduction's complete adds, on 128 bytes a point, 4 a digit and 192 a
// row written.  At the reference's sizes (n < 2048, a few hundred rows)
// the rows do not fill the card, and the reduction's 16 rounds of 256
// adds set the time; two blocks a SM overlap two rows' rounds.  Of the
// three forms measured on an H100 (PERF.md) this one compiles to 128
// registers and no stack; rebuilding the identity where it is used took
// 188 (one block a SM), and a bound of two blocks a SM spilled 80 bytes,
// both slower.  The top window of a 254-bit scalar has 6 bits, so its
// points crowd 63 buckets: its block makes the most adds a thread.
constexpr int NB = 256;               // buckets of a window (c = 8)
constexpr int BUCKET_CHUNK = 2048;    // point indices sorted at a time

__device__ __forceinline__ Pt add_skip_identity(const Pt& p, const Pt& q) {
  if (fe_is_zero(q.z)) return p;
  if (fe_is_zero(p.z)) return q;
  return add_complete(p, q);
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

__global__ void __launch_bounds__(NB) msm_bucket_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const int32_t* __restrict__ digits, int64_t n, int rows,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz) {
  __shared__ Fe sx[NB], sy[NB], sz[NB];
  __shared__ int count[NB];
  __shared__ int fill[NB];
  __shared__ int list[BUCKET_CHUNK];
  const int b = threadIdx.x;
  Pt ident;                                   // the identity (0 : 1 : 0)
  ident.x = fe_zero();
  ident.y = one_mont<FQ>();
  ident.z = fe_zero();
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int32_t* dig = digits + (int64_t)r * n;
    Pt acc = ident;
    for (int64_t c0 = 0; c0 < n; c0 += BUCKET_CHUNK) {
      const int m = (int)min((int64_t)BUCKET_CHUNK, n - c0);
      count[b] = 0;
      __syncthreads();
      for (int t = b; t < m; t += NB) {
        const int d = dig[c0 + t] & (NB - 1);
        if (d) atomicAdd(&count[d], 1);
      }
      __syncthreads();
      // inclusive scan of the counts (Hillis-Steele over the 256 slots)
      const int mine = count[b];
      fill[b] = mine;
      __syncthreads();
      for (int s = 1; s < NB; s <<= 1) {
        const int v = b >= s ? fill[b - s] : 0;
        __syncthreads();
        fill[b] += v;
        __syncthreads();
      }
      const int start = fill[b] - mine;
      __syncthreads();
      fill[b] = start;                        // the scatter's cursor
      __syncthreads();
      for (int t = b; t < m; t += NB) {
        const int d = dig[c0 + t] & (NB - 1);
        if (d) list[atomicAdd(&fill[d], 1)] = (int)(c0 + t);
      }
      __syncthreads();
      for (int j = start; j < start + mine; ++j) {
        const int64_t i = list[j];
        acc = add_mixed(acc, load_fe(px, n, i), load_fe(py, n, i));
      }
      __syncthreads();                        // before the next chunk
    }
    // suffix scan: after the round of shift s, slot b holds the sum of
    // the buckets b .. b + 2s - 1
    Pt cur = acc;
    put_slot(sx, sy, sz, b, cur);
    __syncthreads();
    for (int s = 1; s < NB; s <<= 1) {
      const bool has = b + s < NB;
      Pt other = ident;
      if (has) other = get_slot(sx, sy, sz, b + s);
      __syncthreads();
      if (has) {
        cur = add_skip_identity(cur, other);
        put_slot(sx, sy, sz, b, cur);
      }
      __syncthreads();
    }
    // drop S_0 (the discard bucket's suffix), then the tree sum
    if (b == 0) {
      cur = ident;
      put_slot(sx, sy, sz, 0, cur);
    }
    __syncthreads();
    for (int h = NB / 2; h >= 1; h >>= 1) {
      if (b < h) {
        cur = add_skip_identity(cur, get_slot(sx, sy, sz, b + h));
        put_slot(sx, sy, sz, b, cur);
      }
      __syncthreads();
    }
    if (b == 0) store_pt(ox, oy, oz, rows, r, cur);
    __syncthreads();                          // the slots of the next row
  }
}

}  // namespace

extern "C" {

// Resident blocks a multiprocessor can hold for kernel `which` (0 add,
// 1 add_mixed, 2 double, 3 add_mixed_packed, 4 horner, 5 ladder,
// 6 msm_scan, 7 fixed_base: blocks of THREADS threads; 8 msm_bucket: of
// NB), from the CUDA occupancy calculator.
int h2_point_occupancy(int which, int* blocks) {
  const void* fns[] = {(const void*)point_add_kernel,
                       (const void*)point_add_mixed_kernel,
                       (const void*)point_double_kernel,
                       (const void*)add_mixed_packed_kernel,
                       (const void*)point_horner_kernel,
                       (const void*)point_ladder_kernel,
                       (const void*)msm_scan_kernel,
                       (const void*)fixed_base_kernel,
                       (const void*)msm_bucket_kernel};
  if (which < 0 || which >= 9) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fns[which], which == 8 ? NB : THREADS, 0);
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
// outputs (16, rows) x 3, the rows' totals
int h2_msm_bucket(const void* px, const void* py, const void* digits,
                  long long n, int rows, void* ox, void* oy, void* oz,
                  void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int grid = rows < MAX_BLOCKS ? rows : MAX_BLOCKS;
  msm_bucket_kernel<<<grid, NB, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const int32_t*)digits, n,
      rows, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}

}  // extern "C"
