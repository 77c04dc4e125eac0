// Knuth's TwoSum in exact IEEE arithmetic, shared by the compensated
// kernels (compres.cu, and prolong_comp in transfer.cu).  Every operation
// goes through __fadd_rn/__fsub_rn, which the compiler neither contracts
// into an FMA nor reassociates.

#pragma once

#include <cuda_runtime.h>

namespace {

// s + e == a + b exactly.
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

}  // namespace
