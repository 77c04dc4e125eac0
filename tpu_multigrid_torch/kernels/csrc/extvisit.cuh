// Pieces of a level visit on a ghost-extended block shared by K1-local /
// K2-local (local.cu) and K1f-local / K2f-local (localfas.cu): the coarse
// origin of an even fine origin, the full-weighting aggregate in the TPU
// kernels' order, the zeroing of the coarse block's frame, and the tile
// grid.

#pragma once

#include "ext.cuh"
#include "window.cuh"

namespace {

// floor(x / 2), also for negative x (C's / truncates toward zero).
__device__ __forceinline__ int floor_half(int x) {
  return x >= 0 ? x / 2 : -((1 - x) / 2);
}

// The full-weighting aggregate at window index k, in _fw_aggregate's order.
__device__ __forceinline__ float fw_aggregate(const float* r, int k, int w) {
  auto row3 = [&](int c) {
    return (r[c - w] + 2.0f * r[c]) + r[c + w];
  };
  return 0.25f * ((row3(k - 1) + 2.0f * row3(k)) + row3(k + 1));
}

// Zeroes the cells of the (Rc, Cc) coarse block that no fine cell restricts
// to: the GR/2 rows above and below the restricted rows, and the GC/2
// columns left and right of the restricted columns.  One thread per cell.
__global__ void __launch_bounds__(kThreads)
zero_frame_kernel(float* __restrict__ rc, int Rc, int Cc) {
  const int edge_rows = kGR / 2;
  const int edge_cols = kGC / 2;
  const long long band = 2LL * edge_rows * Cc;
  const long long total = band + (long long)(Rc - 2 * edge_rows) * 2 *
                                     edge_cols;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  int i, j;
  if (t < band) {
    const int row = static_cast<int>(t / Cc);
    i = row < edge_rows ? row : Rc - 2 * edge_rows + row;
    j = static_cast<int>(t % Cc);
  } else {
    const long long q = t - band;
    const int col = static_cast<int>(q % (2 * edge_cols));
    i = edge_rows + static_cast<int>(q / (2 * edge_cols));
    j = col < edge_cols ? col : Cc - 2 * edge_cols + col;
  }
  rc[(size_t)i * Cc + j] = 0.0f;
}

// Launches zero_frame_kernel on the coarse block of an (R, C) fine block.
cudaError_t zero_frame(float* rc, int R, int C, cudaStream_t st) {
  const int Rc = R / 2 + kGR;
  const int Cc = C / 2 + kGC;
  const long long frame = 2LL * (kGR / 2) * Cc + (long long)R / 2 * kGC;
  zero_frame_kernel<<<static_cast<unsigned>((frame + kThreads - 1) /
                                            kThreads),
                      kThreads, 0, st>>>(rc, Rc, Cc);
  return cudaGetLastError();
}

dim3 tile_grid(int R, int C) {
  return dim3((C + kTile - 1) / kTile, (R + kTile - 1) / kTile);
}

}  // namespace
