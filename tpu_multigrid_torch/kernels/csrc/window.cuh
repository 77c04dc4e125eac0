// Shared-memory window machinery of the stencil kernels (stencil.cu) and of
// K1/K2 (transfer.cu): a block owns one kTile x kTile output tile, loads it
// with a halo of rings into shared memory, and runs its smoothing steps there
// (ghost-zone temporal blocking: each step invalidates one ring of the
// window, and the halo is deep enough that no invalid cell reaches an
// output).
//
// Arithmetic: the same operations in the same order as the plain torch
// versions (tpu_multigrid_torch/core/ops.py), built with -fmad=false so that
// nothing is contracted into an FMA.  Cells outside the array read as zero;
// the interior mask is taken from global indices, as in the plain versions.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // output tile side (even)
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMaxWeights = 16;
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kDefaultSmemBytes = 48 * 1024;
constexpr int kMaxDevices = 64;

// Per-step Jacobi weights, rounded to f32 on the host exactly as the plain
// version rounds them: c1 = 1 - w, c2 = w / 4.  Local step s of a launch
// uses entry s % count.
struct Weights {
  float c1[kMaxWeights];
  float c2[kMaxWeights];
  int count;
};

__device__ __forceinline__ bool is_interior(int i, int j, int n) {
  return i >= 1 && i <= n - 1 && j >= 1 && j <= n - 1;
}

// u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1], in the plain version's order.
__device__ __forceinline__ float nbr(const float* v, int k, int w) {
  return ((v[k - w] + v[k + w]) + v[k - 1]) + v[k + 1];
}

// b - 4v + nbr(v) at window index k, in ops.residual's order.
__device__ __forceinline__ float residual_at(const float* v, const float* bw,
                                             int k, int w) {
  return (bw[k] - 4.0f * v[k]) + nbr(v, k, w);
}

// The (w x w) window at global origin (r0, c0); cells outside the array
// read 0.
__device__ void load_window(float* dst, const float* __restrict__ src,
                            int S, int r0, int c0, int w) {
  for (int li = threadIdx.y; li < w; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
      const int gj = c0 + lj;
      dst[li * w + lj] = (gi >= 0 && gi < S && gj >= 0 && gj < S)
                             ? src[(size_t)gi * S + gj]
                             : 0.0f;
    }
  }
}

// Runs `steps` smoothing steps on the window; returns the buffer that holds
// the result (the other one is free).  `first_step` is the global index of
// the launch's first step: RB-GS half-step j updates colour j % 2, so a
// smoothing split over several launches carries its colours on.  The
// outermost ring has no neighbours and keeps its value: it is invalid after
// the first step.
__device__ float* smooth_window(float* v, float* spare, const float* bw,
                                int w, int r0, int c0, int n, int steps,
                                int first_step, int rbgs, const Weights& wt) {
  for (int s = 0; s < steps; ++s) {
    if (rbgs) {
      // Half-step j updates colour j % 2 in place; same-colour nodes do not
      // couple, so no thread reads a node another thread writes.
      const int color = (first_step + s) & 1;
      for (int li = threadIdx.y + 1; li < w - 1; li += blockDim.y) {
        const int gi = r0 + li;
        for (int lj = threadIdx.x + 1; lj < w - 1; lj += blockDim.x) {
          const int gj = c0 + lj;
          const int k = li * w + lj;
          if (is_interior(gi, gj, n) && ((gi + gj) & 1) == color) {
            v[k] = 0.25f * (bw[k] + nbr(v, k, w));
          }
        }
      }
    } else {
      const float c1 = wt.c1[s % wt.count];
      const float c2 = wt.c2[s % wt.count];
      for (int li = threadIdx.y; li < w; li += blockDim.y) {
        const int gi = r0 + li;
        for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
          const int gj = c0 + lj;
          const int k = li * w + lj;
          float out = v[k];
          if (li > 0 && li < w - 1 && lj > 0 && lj < w - 1) {
            out = is_interior(gi, gj, n)
                      ? c1 * v[k] + c2 * (bw[k] + nbr(v, k, w))
                      : 0.0f;
          }
          spare[k] = out;
        }
      }
      float* t = v;
      v = spare;
      spare = t;
    }
    __syncthreads();
  }
  return v;
}

// Runs `steps` steps of a pointwise operator `op` on the window, each from
// the state before it into the other buffer, and returns the buffer that
// holds the result (the other one is free): op.step(v, bw, k, w) at
// interior nodes, 0 at the other inner cells.  The outermost ring has no
// neighbours and keeps its value: it is invalid after the first step.  The
// FAS kernels (fas.cu) run their nonlinear Jacobi-Newton and Picard-Jacobi
// steps here.
template <typename Op>
__device__ float* smooth_window_op(float* v, float* spare, const float* bw,
                                   int w, int r0, int c0, int n, int steps,
                                   const Op& op) {
  for (int s = 0; s < steps; ++s) {
    for (int li = threadIdx.y; li < w; li += blockDim.y) {
      const int gi = r0 + li;
      for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
        const int gj = c0 + lj;
        const int k = li * w + lj;
        float out = v[k];
        if (li > 0 && li < w - 1 && lj > 0 && lj < w - 1) {
          out = is_interior(gi, gj, n) ? op.step(v, bw, k, w) : 0.0f;
        }
        spare[k] = out;
      }
    }
    float* t = v;
    v = spare;
    spare = t;
    __syncthreads();
  }
  return v;
}

// Two f32 windows for the iterate plus one for b.
int window_bytes(int halo) {
  const int w = kTile + 2 * halo;
  return 3 * w * w * static_cast<int>(sizeof(float));
}

cudaError_t make_weights(const float* host, int count, Weights* wt) {
  if (count < 1 || count > kMaxWeights) return cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    wt->c1[i] = host[i];
    wt->c2[i] = host[count + i];
  }
  for (int i = count; i < kMaxWeights; ++i) {
    wt->c1[i] = 0.0f;
    wt->c2[i] = 0.0f;
  }
  wt->count = count;
  return cudaSuccess;
}

// Opts `kernel` in to `bytes` of dynamic shared memory on the current
// device.  The attribute holds per device, so `configured[device]` keeps the
// largest opt-in made there (0 until the first one); devices past
// kMaxDevices set it at every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* configured) {
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (bytes <= kDefaultSmemBytes) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && bytes <= configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (cached) configured[device] = bytes;
  return cudaSuccess;
}

}  // namespace
