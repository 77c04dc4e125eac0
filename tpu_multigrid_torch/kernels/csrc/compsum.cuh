// The compensated residual cascades of a double-single and a triple-single
// iterate at one node, shared by compres.cu (square levels, and 3D grids)
// and localref.cu (ghost-extended blocks).  The callers fetch the node's
// values and its four neighbours (up, down, left, right: i-1, i+1, j-1,
// j+1), or in 3D its six (z-1, z+1, y-1, y+1, x-1, x+1); the cascades are
// those of tpu_multigrid_torch/precision.py::_ds_cascade / _ts_cascade, in
// their order, every operation through __fadd_rn/__fsub_rn/__fmul_rn.

#pragma once

#include "twosum.cuh"

namespace {

// Neighbour sum with Neumaier compensation, terms in the plain version's
// order: s + c is the exact sum.
__device__ __forceinline__ void nbr_comp(const float n[4], float& s,
                                         float& c) {
  float e;
  s = n[0];
  c = 0.0f;
  two_sum(s, n[1], s, e);
  c = __fadd_rn(c, e);
  two_sum(s, n[2], s, e);
  c = __fadd_rn(c, e);
  two_sum(s, n[3], s, e);
  c = __fadd_rn(c, e);
}

// A(x) = 4x - ((n0 + n1) + n2) + n3 in plain f32: the smallest component's
// term.
__device__ __forceinline__ float apply_a(float x, const float n[4]) {
  return __fsub_rn(__fmul_rn(4.0f, x),
                   __fadd_rn(__fadd_rn(__fadd_rn(n[0], n[1]), n[2]), n[3]));
}

// r = b - A(uh + ul) to ~eps^2.
__device__ __forceinline__ float ds_resid(float b, float uh,
                                          const float nh[4], float ul,
                                          const float nl[4]) {
  float nbr_h, c_h, s, e1, e2, c1, c2, c3, c4;
  nbr_comp(nh, nbr_h, c_h);
  two_sum(b, nbr_h, s, e1);
  two_sum(s, __fmul_rn(-4.0f, uh), s, e2);
  const float a_lo = apply_a(ul, nl);
  two_sum(s, e1, s, c1);
  two_sum(s, e2, s, c2);
  two_sum(s, c_h, s, c3);
  two_sum(s, -a_lo, s, c4);
  return __fadd_rn(s, __fadd_rn(c1, __fadd_rn(c2, __fadd_rn(c3, c4))));
}

// r = b - A(uh + um + ul) to ~eps^3.
__device__ __forceinline__ float ts_resid(float b, float uh,
                                          const float nh[4], float um,
                                          const float nm[4], float ul,
                                          const float nl[4]) {
  float nbr_h, c_h, nbr_m, c_m, s, e1, e2, e3, e4;
  float c1, c2, c3, c4, c5, c6, c7;
  nbr_comp(nh, nbr_h, c_h);
  nbr_comp(nm, nbr_m, c_m);
  two_sum(b, nbr_h, s, e1);
  two_sum(s, __fmul_rn(-4.0f, uh), s, e2);
  two_sum(s, nbr_m, s, e3);
  two_sum(s, __fmul_rn(-4.0f, um), s, e4);
  const float a_l = apply_a(ul, nl);
  two_sum(s, e1, s, c1);
  two_sum(s, e2, s, c2);
  two_sum(s, e3, s, c3);
  two_sum(s, e4, s, c4);
  two_sum(s, c_h, s, c5);
  two_sum(s, c_m, s, c6);
  two_sum(s, -a_l, s, c7);
  const float tail = __fadd_rn(
      c1, __fadd_rn(c2, __fadd_rn(c3, __fadd_rn(c4, __fadd_rn(
                                              c5, __fadd_rn(c6, c7))))));
  return __fadd_rn(s, tail);
}

// The 7-point forms: six neighbours in the order of precision.py's 3D rolls
// (z-1, z+1, y-1, y+1, x-1, x+1), the diagonal 6 u split into the exact
// -4 u and -2 u terms (precision.py::_diag_terms).

// Neighbour sum with Neumaier compensation: s + c is the exact sum.
__device__ __forceinline__ void nbr_comp6(const float n[6], float& s,
                                          float& c) {
  float e;
  s = n[0];
  c = 0.0f;
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    two_sum(s, n[k], s, e);
    c = __fadd_rn(c, e);
  }
}

// A(x) = 6x - ((((n0 + n1) + n2) + n3) + n4) + n5 in plain f32
// (ops3d.neighbor_sum3's order).
__device__ __forceinline__ float apply_a6(float x, const float n[6]) {
  float t = __fadd_rn(n[0], n[1]);
#pragma unroll
  for (int k = 2; k < 6; ++k) t = __fadd_rn(t, n[k]);
  return __fsub_rn(__fmul_rn(6.0f, x), t);
}

// Adds a component's diagonal terms -4x and -2x into s by TwoSum, keeping
// their two errors.
__device__ __forceinline__ void diag_terms3(float x, float& s, float& e4,
                                            float& e2) {
  two_sum(s, __fmul_rn(-4.0f, x), s, e4);
  two_sum(s, __fmul_rn(-2.0f, x), s, e2);
}

// r = b - A(uh + ul) to ~eps^2, 7-point.
__device__ __forceinline__ float ds_resid3(float b, float uh,
                                           const float nh[6], float ul,
                                           const float nl[6]) {
  float nbr_h, c_h, s, e1, e2, e3, c1, c2, c3, c4, c5;
  nbr_comp6(nh, nbr_h, c_h);
  two_sum(b, nbr_h, s, e1);
  diag_terms3(uh, s, e2, e3);
  const float a_lo = apply_a6(ul, nl);
  two_sum(s, e1, s, c1);
  two_sum(s, e2, s, c2);
  two_sum(s, e3, s, c3);
  two_sum(s, c_h, s, c4);
  two_sum(s, -a_lo, s, c5);
  return __fadd_rn(
      s, __fadd_rn(c1, __fadd_rn(c2, __fadd_rn(c3, __fadd_rn(c4, c5)))));
}

// r = b - A(uh + um + ul) to ~eps^3, 7-point.
__device__ __forceinline__ float ts_resid3(float b, float uh,
                                           const float nh[6], float um,
                                           const float nm[6], float ul,
                                           const float nl[6]) {
  float nbr_h, c_h, nbr_m, c_m, s, e[6], c[9];
  nbr_comp6(nh, nbr_h, c_h);
  nbr_comp6(nm, nbr_m, c_m);
  two_sum(b, nbr_h, s, e[0]);
  diag_terms3(uh, s, e[1], e[2]);
  two_sum(s, nbr_m, s, e[3]);
  diag_terms3(um, s, e[4], e[5]);
  const float a_l = apply_a6(ul, nl);
#pragma unroll
  for (int k = 0; k < 6; ++k) two_sum(s, e[k], s, c[k]);
  two_sum(s, c_h, s, c[6]);
  two_sum(s, c_m, s, c[7]);
  two_sum(s, -a_l, s, c[8]);
  float tail = c[8];
#pragma unroll
  for (int k = 7; k >= 0; --k) tail = __fadd_rn(c[k], tail);
  return __fadd_rn(s, tail);
}

}  // namespace
