// BN254 Fr / Fq arithmetic for one element per thread, Montgomery form
// with R = 2^256.
//
// Storage (shared with the Python side, fields/limbs.py): a field element
// is 16 limbs of 16 bits, one limb per 32-bit word, limbs-leading: limb j
// of element i sits at word j*limb_stride + i.  Neighbouring threads read
// neighbouring words, so every access is coalesced.  In registers the 16
// limbs are gathered into 8 words of 32 bits and the arithmetic runs on
// carry chains (add.cc / addc / mad.lo.cc / madc.hi.cc).
//
// These device functions are the arithmetic of the reference's
// fields/ssa.py (add_mod, sub_mod, neg_mod, mont_mul, mont_sqr), written
// for a register machine instead of full-tile vector values.
#pragma once

#include <cstdint>

namespace h2 {

constexpr int NL = 16;  // 16-bit limbs of an element in memory
constexpr int NW = 8;   // 32-bit words of an element in registers

constexpr int FR = 0;   // scalar field
constexpr int FQ = 1;   // base field

// little-endian 32-bit words of the two moduli
static __constant__ uint32_t MODULUS[2][NW] = {
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}};
// -p^{-1} mod 2^32
static __constant__ uint32_t MONT_INV[2] = {0xefffffffu, 0xe4866389u};
// R = 2^256 mod p: one in Montgomery form
static __constant__ uint32_t ONE_MONT[2][NW] = {
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
     0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};

struct Fe {
  uint32_t w[NW];
};

__device__ __forceinline__ Fe load_fe(const uint32_t* p, int64_t limb_stride,
                                      int64_t idx) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint32_t lo = p[(int64_t)(2 * k) * limb_stride + idx];
    uint32_t hi = p[(int64_t)(2 * k + 1) * limb_stride + idx];
    r.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void store_fe(uint32_t* p, int64_t limb_stride,
                                         int64_t idx, const Fe& v) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    p[(int64_t)(2 * k) * limb_stride + idx] = v.w[k] & 0xFFFFu;
    p[(int64_t)(2 * k + 1) * limb_stride + idx] = v.w[k] >> 16;
  }
}

template <int F>
__device__ __forceinline__ Fe modulus() {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = MODULUS[F][k];
  return r;
}

template <int F>
__device__ __forceinline__ Fe one_mont() {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = ONE_MONT[F][k];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) acc |= a.w[k];
  return acc == 0;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = 0;
  return r;
}

// r = a + b over 256 bits; returns the carry out (0 or 1)
__device__ __forceinline__ uint32_t add8(Fe& r, const Fe& a, const Fe& b) {
  uint32_t carry;
  asm("add.cc.u32   %0, %9,  %17;\n\t"
      "addc.cc.u32  %1, %10, %18;\n\t"
      "addc.cc.u32  %2, %11, %19;\n\t"
      "addc.cc.u32  %3, %12, %20;\n\t"
      "addc.cc.u32  %4, %13, %21;\n\t"
      "addc.cc.u32  %5, %14, %22;\n\t"
      "addc.cc.u32  %6, %15, %23;\n\t"
      "addc.cc.u32  %7, %16, %24;\n\t"
      "addc.u32     %8, 0, 0;\n\t"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
        "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7]), "=r"(carry)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
        "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]),
        "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
  return carry;
}

// r = a - b over 256 bits; returns the borrow out (0 or 1)
__device__ __forceinline__ uint32_t sub8(Fe& r, const Fe& a, const Fe& b) {
  uint32_t borrow;
  asm("sub.cc.u32   %0, %9,  %17;\n\t"
      "subc.cc.u32  %1, %10, %18;\n\t"
      "subc.cc.u32  %2, %11, %19;\n\t"
      "subc.cc.u32  %3, %12, %20;\n\t"
      "subc.cc.u32  %4, %13, %21;\n\t"
      "subc.cc.u32  %5, %14, %22;\n\t"
      "subc.cc.u32  %6, %15, %23;\n\t"
      "subc.cc.u32  %7, %16, %24;\n\t"
      "subc.u32     %8, 0, 0;\n\t"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
        "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7]), "=r"(borrow)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
        "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]),
        "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
  // subc.u32 of 0 - 0 - borrow is 0 or 0xFFFFFFFF
  return borrow & 1u;
}

// x in [0, 2p) -> x mod p
template <int F>
__device__ __forceinline__ Fe cond_sub_p(const Fe& x) {
  Fe d;
  uint32_t borrow = sub8(d, x, modulus<F>());
  return borrow ? x : d;
}

template <int F>
__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b) {
  Fe s;
  add8(s, a, b);  // a + b < 2p < 2^255: no carry out
  return cond_sub_p<F>(s);
}

template <int F>
__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b) {
  Fe d;
  uint32_t borrow = sub8(d, a, b);
  if (borrow) {
    Fe e;
    add8(e, d, modulus<F>());
    return e;
  }
  return d;
}

template <int F>
__device__ __forceinline__ Fe neg_mod(const Fe& a) {
  if (fe_is_zero(a)) return a;
  Fe d;
  sub8(d, modulus<F>(), a);
  return d;
}

// t[0..9] += x * y, x of 8 words, y one word.  Two carry chains: the low
// halves of the 8 products, then the high halves one word up.
__device__ __forceinline__ void mad_row(uint32_t (&t)[NW + 2], const Fe& x,
                                        uint32_t y) {
  asm("mad.lo.cc.u32   %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32  %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32  %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32  %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32  %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32  %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32  %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32  %7, %17, %18, %7;\n\t"
      "addc.cc.u32     %8, %8, 0;\n\t"
      "addc.u32        %9, %9, 0;\n\t"
      "mad.hi.cc.u32   %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32  %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32  %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32  %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32  %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32  %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32  %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32  %8, %17, %18, %8;\n\t"
      "addc.u32        %9, %9, 0;\n\t"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(x.w[0]), "r"(x.w[1]), "r"(x.w[2]), "r"(x.w[3]),
        "r"(x.w[4]), "r"(x.w[5]), "r"(x.w[6]), "r"(x.w[7]), "r"(y));
}

// Montgomery product a*b/R mod p (CIOS: one row of a*b_i, one row of m*p,
// one word shift, eight times; everything stays in registers)
template <int F>
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; ++k) t[k] = 0;
  const Fe p = modulus<F>();
  const uint32_t inv = MONT_INV[F];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    mad_row(t, a, b.w[i]);
    uint32_t m = t[0] * inv;
    mad_row(t, p, m);  // makes t[0] zero
#pragma unroll
    for (int k = 0; k < NW + 1; ++k) t[k] = t[k + 1];
    t[NW + 1] = 0;
  }
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = t[k];
  // inputs < p give a result < 2p < 2^255, so t[8] is zero here
  return cond_sub_p<F>(r);
}

// t[0..15] = a^2, the full 512 bits: the 28 products a_i a_j (i < j) once
// each, in one row per i (low halves, then high halves one word up),
// doubled by a one-bit shift, then the 8 squares a_i^2 on the diagonal.
// 36 word products (72 multiply-adds) against a product's 64.
__device__ __forceinline__ void sqr_wide(uint32_t (&t)[2 * NW], const Fe& a) {
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) t[k] = 0;
  asm("mad.lo.cc.u32   %1, %16, %17, %1;\n\t"
      "madc.lo.cc.u32  %2, %16, %18, %2;\n\t"
      "madc.lo.cc.u32  %3, %16, %19, %3;\n\t"
      "madc.lo.cc.u32  %4, %16, %20, %4;\n\t"
      "madc.lo.cc.u32  %5, %16, %21, %5;\n\t"
      "madc.lo.cc.u32  %6, %16, %22, %6;\n\t"
      "madc.lo.cc.u32  %7, %16, %23, %7;\n\t"
      "addc.u32        %8, %8, 0;\n\t"
      "mad.hi.cc.u32   %2, %16, %17, %2;\n\t"
      "madc.hi.cc.u32  %3, %16, %18, %3;\n\t"
      "madc.hi.cc.u32  %4, %16, %19, %4;\n\t"
      "madc.hi.cc.u32  %5, %16, %20, %5;\n\t"
      "madc.hi.cc.u32  %6, %16, %21, %6;\n\t"
      "madc.hi.cc.u32  %7, %16, %22, %7;\n\t"
      "madc.hi.cc.u32  %8, %16, %23, %8;\n\t"
      "addc.u32        %9, %9, 0;\n\t"
      "mad.lo.cc.u32   %3, %17, %18, %3;\n\t"
      "madc.lo.cc.u32  %4, %17, %19, %4;\n\t"
      "madc.lo.cc.u32  %5, %17, %20, %5;\n\t"
      "madc.lo.cc.u32  %6, %17, %21, %6;\n\t"
      "madc.lo.cc.u32  %7, %17, %22, %7;\n\t"
      "madc.lo.cc.u32  %8, %17, %23, %8;\n\t"
      "addc.u32        %9, %9, 0;\n\t"
      "mad.hi.cc.u32   %4, %17, %18, %4;\n\t"
      "madc.hi.cc.u32  %5, %17, %19, %5;\n\t"
      "madc.hi.cc.u32  %6, %17, %20, %6;\n\t"
      "madc.hi.cc.u32  %7, %17, %21, %7;\n\t"
      "madc.hi.cc.u32  %8, %17, %22, %8;\n\t"
      "madc.hi.cc.u32  %9, %17, %23, %9;\n\t"
      "addc.u32        %10, %10, 0;\n\t"
      "mad.lo.cc.u32   %5, %18, %19, %5;\n\t"
      "madc.lo.cc.u32  %6, %18, %20, %6;\n\t"
      "madc.lo.cc.u32  %7, %18, %21, %7;\n\t"
      "madc.lo.cc.u32  %8, %18, %22, %8;\n\t"
      "madc.lo.cc.u32  %9, %18, %23, %9;\n\t"
      "addc.u32        %10, %10, 0;\n\t"
      "mad.hi.cc.u32   %6, %18, %19, %6;\n\t"
      "madc.hi.cc.u32  %7, %18, %20, %7;\n\t"
      "madc.hi.cc.u32  %8, %18, %21, %8;\n\t"
      "madc.hi.cc.u32  %9, %18, %22, %9;\n\t"
      "madc.hi.cc.u32  %10, %18, %23, %10;\n\t"
      "addc.u32        %11, %11, 0;\n\t"
      "mad.lo.cc.u32   %7, %19, %20, %7;\n\t"
      "madc.lo.cc.u32  %8, %19, %21, %8;\n\t"
      "madc.lo.cc.u32  %9, %19, %22, %9;\n\t"
      "madc.lo.cc.u32  %10, %19, %23, %10;\n\t"
      "addc.u32        %11, %11, 0;\n\t"
      "mad.hi.cc.u32   %8, %19, %20, %8;\n\t"
      "madc.hi.cc.u32  %9, %19, %21, %9;\n\t"
      "madc.hi.cc.u32  %10, %19, %22, %10;\n\t"
      "madc.hi.cc.u32  %11, %19, %23, %11;\n\t"
      "addc.u32        %12, %12, 0;\n\t"
      "mad.lo.cc.u32   %9, %20, %21, %9;\n\t"
      "madc.lo.cc.u32  %10, %20, %22, %10;\n\t"
      "madc.lo.cc.u32  %11, %20, %23, %11;\n\t"
      "addc.u32        %12, %12, 0;\n\t"
      "mad.hi.cc.u32   %10, %20, %21, %10;\n\t"
      "madc.hi.cc.u32  %11, %20, %22, %11;\n\t"
      "madc.hi.cc.u32  %12, %20, %23, %12;\n\t"
      "addc.u32        %13, %13, 0;\n\t"
      "mad.lo.cc.u32   %11, %21, %22, %11;\n\t"
      "madc.lo.cc.u32  %12, %21, %23, %12;\n\t"
      "addc.u32        %13, %13, 0;\n\t"
      "mad.hi.cc.u32   %12, %21, %22, %12;\n\t"
      "madc.hi.cc.u32  %13, %21, %23, %13;\n\t"
      "addc.u32        %14, %14, 0;\n\t"
      "mad.lo.cc.u32   %13, %22, %23, %13;\n\t"
      "addc.u32        %14, %14, 0;\n\t"
      "mad.hi.cc.u32   %14, %22, %23, %14;\n\t"
      "addc.u32        %15, %15, 0;\n\t"
      "add.cc.u32      %1, %1, %1;\n\t"
      "addc.cc.u32     %2, %2, %2;\n\t"
      "addc.cc.u32     %3, %3, %3;\n\t"
      "addc.cc.u32     %4, %4, %4;\n\t"
      "addc.cc.u32     %5, %5, %5;\n\t"
      "addc.cc.u32     %6, %6, %6;\n\t"
      "addc.cc.u32     %7, %7, %7;\n\t"
      "addc.cc.u32     %8, %8, %8;\n\t"
      "addc.cc.u32     %9, %9, %9;\n\t"
      "addc.cc.u32     %10, %10, %10;\n\t"
      "addc.cc.u32     %11, %11, %11;\n\t"
      "addc.cc.u32     %12, %12, %12;\n\t"
      "addc.cc.u32     %13, %13, %13;\n\t"
      "addc.cc.u32     %14, %14, %14;\n\t"
      "addc.u32        %15, %15, %15;\n\t"
      "mad.lo.cc.u32   %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32  %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32  %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32  %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32  %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32  %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32  %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32  %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32  %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32  %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32  %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32  %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32  %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32  %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32  %14, %23, %23, %14;\n\t"
      "madc.hi.u32     %15, %23, %23, %15;\n\t"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
        "+r"(t[15])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
        "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
}

// Montgomery square a^2/R mod p, equal to mont_mul(a, a) word for word.
// T = a^2 (sqr_wide), then Montgomery reduction of its low half alone:
// u = (T_lo + M p) / R with M = -T p^-1 mod R, eight rows of m*p in the
// CIOS window, and the result T_hi + u = (T + M p) / R.  For a < p,
// T_hi < p^2 / R < p / 4 and u <= p, so one conditional subtraction
// leaves it in [0, p).  208 multiply-adds against mont_mul's 264.
template <int F>
__device__ __forceinline__ Fe mont_sqr(const Fe& a) {
  uint32_t T[2 * NW];
  sqr_wide(T, a);
  uint32_t t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW; ++k) t[k] = T[k];
  t[NW] = t[NW + 1] = 0;
  const Fe p = modulus<F>();
  const uint32_t inv = MONT_INV[F];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t m = t[0] * inv;
    mad_row(t, p, m);  // makes t[0] zero; the window stays below 2^288
#pragma unroll
    for (int k = 0; k < NW + 1; ++k) t[k] = t[k + 1];
    t[NW + 1] = 0;
  }
  Fe u, hi, r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u.w[k] = t[k];
    hi.w[k] = T[NW + k];
  }
  add8(r, u, hi);  // below 5p/4 + 1 < 2^255: no carry out
  return cond_sub_p<F>(r);
}

}  // namespace h2
