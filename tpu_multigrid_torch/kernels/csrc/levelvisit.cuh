// Pieces of a level visit shared by K1/K2 (transfer.cu) and K1v/K2v
// (vartransfer.cu): the full-weighting row blur, bilinear prolongation at a
// fine node, and the fixed-order block sum of the resnorm partials.

#pragma once

#include "window.cuh"

namespace {

// The [1/2, 1, 1/2] blur along a row, at window index k.
__device__ __forceinline__ float row_blur(const float* r, int k) {
  return r[k] + 0.5f * (r[k - 1] + r[k + 1]);
}

// Bilinear prolongation of ec at fine node (gi, gj) >= 0; coarse nodes at or
// past m read 0 (the plain version's crop).
__device__ __forceinline__ float prolong_at(const float* __restrict__ ec,
                                            int Sc, int m, int gi, int gj) {
  const int I = gi >> 1;
  const int J = gj >> 1;
  auto c = [&](int a, int bb) {
    return (a < m && bb < m) ? __ldg(ec + (size_t)a * Sc + bb) : 0.0f;
  };
  const bool odd_i = gi & 1;
  const bool odd_j = gj & 1;
  if (!odd_i && !odd_j) return c(I, J);
  if (odd_i && !odd_j) return 0.5f * (c(I, J) + c(I + 1, J));
  if (!odd_i && odd_j) return 0.5f * (c(I, J) + c(I, J + 1));
  return 0.25f * (((c(I, J) + c(I, J + 1)) + c(I + 1, J)) + c(I + 1, J + 1));
}

__device__ float block_sum(float acc, float* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  red[tid] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

// One block adds the partials in a fixed order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int count,
                    float* __restrict__ out) {
  __shared__ float red[kThreads];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  for (int i = tid; i < count; i += kThreads) acc += partials[i];
  const float total = block_sum(acc, red);
  if (tid == 0) out[0] = total;
}

}  // namespace
