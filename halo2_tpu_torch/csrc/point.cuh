// Complete G1 formulas for BN254 (y^2 = x^3 + 3) in homogeneous projective
// coordinates over Fq: Renes-Costello-Batina 2015, algorithms 7, 8 and 9
// for a = 0, b3 = 9.  The same sequence of field operations as the Python
// specification in curves/formulas.py, one point per thread, every
// intermediate in registers.
#pragma once

#include "field.cuh"

namespace h2 {

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Fe fq_add(const Fe& a, const Fe& b) {
  return add_mod<FQ>(a, b);
}
__device__ __forceinline__ Fe fq_sub(const Fe& a, const Fe& b) {
  return sub_mod<FQ>(a, b);
}
// The field product of the formulas: not inlined, so the formulas hold one
// copy of the CIOS body, with operands and result passed by value, in
// registers (no stack frame).  Of the three forms measured on an H100 (this
// one, the same by reference, and inlined everywhere; PERF.md section 6) it
// was the fastest on five of the six point kernels.
__device__ __noinline__ Fe fq_mul(Fe a, Fe b) { return mont_mul<FQ>(a, b); }

__device__ __forceinline__ Fe mul_by_9(const Fe& a) {
  Fe a2 = fq_add(a, a);
  Fe a4 = fq_add(a2, a2);
  Fe a8 = fq_add(a4, a4);
  return fq_add(a8, a);
}

// RCB15 algorithm 7: projective + projective
__device__ __forceinline__ Pt add_complete(const Pt& p, const Pt& q) {
  Fe t0 = fq_mul(p.x, q.x);
  Fe t1 = fq_mul(p.y, q.y);
  Fe t2 = fq_mul(p.z, q.z);
  Fe t3 = fq_add(p.x, p.y);
  Fe t4 = fq_add(q.x, q.y);
  t3 = fq_mul(t3, t4);
  t4 = fq_add(t0, t1);
  t3 = fq_sub(t3, t4);
  t4 = fq_add(p.y, p.z);
  Fe x3 = fq_add(q.y, q.z);
  t4 = fq_mul(t4, x3);
  x3 = fq_add(t1, t2);
  t4 = fq_sub(t4, x3);
  x3 = fq_add(p.x, p.z);
  Fe y3 = fq_add(q.x, q.z);
  x3 = fq_mul(x3, y3);
  y3 = fq_add(t0, t2);
  y3 = fq_sub(x3, y3);
  x3 = fq_add(t0, t0);
  t0 = fq_add(x3, t0);
  t2 = mul_by_9(t2);
  Fe z3 = fq_add(t1, t2);
  t1 = fq_sub(t1, t2);
  y3 = mul_by_9(y3);
  x3 = fq_mul(t4, y3);
  t2 = fq_mul(t3, t1);
  x3 = fq_sub(t2, x3);
  y3 = fq_mul(y3, t0);
  t1 = fq_mul(t1, z3);
  y3 = fq_add(t1, y3);
  t0 = fq_mul(t0, t3);
  z3 = fq_mul(z3, t4);
  z3 = fq_add(z3, t0);
  Pt r;
  r.x = x3;
  r.y = y3;
  r.z = z3;
  return r;
}

// RCB15 algorithm 8: projective + affine (the affine point is not the
// identity)
__device__ __forceinline__ Pt add_mixed(const Pt& p, const Fe& x2,
                                        const Fe& y2) {
  Fe t0 = fq_mul(p.x, x2);
  Fe t1 = fq_mul(p.y, y2);
  Fe t3 = fq_add(x2, y2);
  Fe t4 = fq_add(p.x, p.y);
  t3 = fq_mul(t3, t4);
  t4 = fq_add(t0, t1);
  t3 = fq_sub(t3, t4);
  t4 = fq_mul(y2, p.z);
  t4 = fq_add(t4, p.y);
  Fe y3 = fq_mul(x2, p.z);
  y3 = fq_add(y3, p.x);
  Fe x3 = fq_add(t0, t0);
  t0 = fq_add(x3, t0);
  Fe t2 = mul_by_9(p.z);
  Fe z3 = fq_add(t1, t2);
  t1 = fq_sub(t1, t2);
  y3 = mul_by_9(y3);
  x3 = fq_mul(t4, y3);
  t2 = fq_mul(t3, t1);
  x3 = fq_sub(t2, x3);
  y3 = fq_mul(y3, t0);
  t1 = fq_mul(t1, z3);
  y3 = fq_add(t1, y3);
  t0 = fq_mul(t0, t3);
  z3 = fq_mul(z3, t4);
  z3 = fq_add(z3, t0);
  Pt r;
  r.x = x3;
  r.y = y3;
  r.z = z3;
  return r;
}

// RCB15 algorithm 9: doubling
__device__ __forceinline__ Pt double_complete(const Pt& p) {
  Fe t0 = fq_mul(p.y, p.y);
  Fe z3 = fq_add(t0, t0);
  z3 = fq_add(z3, z3);
  z3 = fq_add(z3, z3);
  Fe t1 = fq_mul(p.y, p.z);
  Fe t2 = fq_mul(p.z, p.z);
  t2 = mul_by_9(t2);
  Fe x3 = fq_mul(t2, z3);
  Fe y3 = fq_add(t0, t2);
  z3 = fq_mul(t1, z3);
  t1 = fq_add(t2, t2);
  t2 = fq_add(t1, t2);
  t0 = fq_sub(t0, t2);
  y3 = fq_mul(t0, y3);
  y3 = fq_add(x3, y3);
  t1 = fq_mul(p.x, p.y);
  x3 = fq_mul(t0, t1);
  x3 = fq_add(x3, x3);
  Pt r;
  r.x = x3;
  r.y = y3;
  r.z = z3;
  return r;
}

}  // namespace h2
