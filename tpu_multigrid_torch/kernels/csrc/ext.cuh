// The ghost-extended block layout shared by local.cu and localref.cu: GR
// ghost rows and GC ghost columns a side, and the coarse block's mapping,
// fine cell (i, j) reading the coarse cells around (i/2 + GR/2, j/2 + GC/2).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kGR = 16;   // ghost rows per side
constexpr int kGC = 256;  // ghost columns per side

// Bilinear prolongation of the coarse block ec (Cc columns) at fine cell
// (i, j) >= 0, in _bilinear_prolong's order: 2x2 replication, then the
// average with the next row, then with the next column (the averages of a
// value with itself are exact and left out).
__device__ __forceinline__ float prolong_ext(const float* __restrict__ ec,
                                             int Cc, int i, int j) {
  const int I = (i >> 1) + kGR / 2;
  const int J = (j >> 1) + kGC / 2;
  auto c = [&](int a, int bb) { return __ldg(ec + (size_t)a * Cc + bb); };
  const bool odd_i = i & 1;
  const bool odd_j = j & 1;
  if (!odd_i && !odd_j) return c(I, J);
  if (odd_i && !odd_j) return 0.5f * (c(I, J) + c(I + 1, J));
  if (!odd_i && odd_j) return 0.5f * (c(I, J) + c(I, J + 1));
  return 0.5f * (0.5f * (c(I, J) + c(I + 1, J)) +
                 0.5f * (c(I, J + 1) + c(I + 1, J + 1)));
}

}  // namespace
