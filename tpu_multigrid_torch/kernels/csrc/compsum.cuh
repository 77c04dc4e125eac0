// The compensated residual cascades of a double-single and a triple-single
// iterate at one node, shared by compres.cu (square levels) and localref.cu
// (ghost-extended blocks).  The callers fetch the node's values and its four
// neighbours (up, down, left, right: i-1, i+1, j-1, j+1); the cascades are
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

}  // namespace
