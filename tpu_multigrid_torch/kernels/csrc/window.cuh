// Shared-memory window machinery of K1/K2 (transfer.cu) and of the kernels
// built on them (local.cu, fas.cu, localfas.cu, levelvisit.cuh's users; the
// streaming smoother, stencil.cu, marches down rows instead and takes only
// the constants and allow_smem here): a block owns one kTile x kTile output
// tile, loads it with a halo of rings into shared memory, and runs its
// smoothing steps there (ghost-zone temporal blocking: each step invalidates
// one ring of the window, and the halo is deep enough that no invalid cell
// reaches an output).
//
// Arithmetic: the same operations in the same order as the plain torch
// versions (tpu_multigrid_torch/core/ops.py), built with -fmad=false so that
// nothing is contracted into an FMA.  Cells outside the array read as zero;
// the interior mask is taken from global indices, as in the plain versions.
//
// The loader and the step loop are templates on a geometry policy, which
// says where the array ends, which cells are live unknowns and which colour
// a cell has: SquareGeom is the padded (S, S) Dirichlet level, ExtGeom a
// ghost-extended (R, C) block whose masks are offset by its global origin
// (local.cu, localfas.cu).

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

// The (S x S) padded Dirichlet level: unknowns at the interior 1..n-1.
struct SquareGeom {
  int S;
  int n;
  __device__ __forceinline__ bool in_array(int i, int j) const {
    return i >= 0 && i < S && j >= 0 && j < S;
  }
  __device__ __forceinline__ size_t at(int i, int j) const {
    return (size_t)i * S + j;
  }
  __device__ __forceinline__ bool live(int i, int j) const {
    return is_interior(i, j, n);
  }
  __device__ __forceinline__ int color(int i, int j) const {
    return (i + j) & 1;
  }
};

// A ghost-extended (R x C) block whose cell (i, j) has the global
// coordinates (o0 + i, o1 + j): the live unknowns are the cells of the
// array whose global coordinates lie in 1..n-1, and a cell's colour is the
// parity of its global coordinates.
struct ExtGeom {
  int R;
  int C;
  int o0;
  int o1;
  int n;
  __device__ __forceinline__ bool in_array(int i, int j) const {
    return i >= 0 && i < R && j >= 0 && j < C;
  }
  __device__ __forceinline__ size_t at(int i, int j) const {
    return (size_t)i * C + j;
  }
  __device__ __forceinline__ bool live(int i, int j) const {
    return in_array(i, j) && is_interior(o0 + i, o1 + j, n);
  }
  __device__ __forceinline__ int color(int i, int j) const {
    return (o0 + i + o1 + j) & 1;
  }
};

// u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1], in the plain version's order.
__device__ __forceinline__ float nbr(const float* v, int k, int w) {
  return ((v[k - w] + v[k + w]) + v[k - 1]) + v[k + 1];
}

// b - 4v + nbr(v) at window index k, in ops.residual's order.
__device__ __forceinline__ float residual_at(const float* v, const float* bw,
                                             int k, int w) {
  return (bw[k] - 4.0f * v[k]) + nbr(v, k, w);
}

// The (w x w) window at array origin (r0, c0); cells outside the array
// read 0.
template <typename Geom>
__device__ void load_window(float* dst, const float* __restrict__ src,
                            const Geom& g, int r0, int c0, int w) {
  for (int li = threadIdx.y; li < w; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
      const int gj = c0 + lj;
      dst[li * w + lj] = g.in_array(gi, gj) ? src[g.at(gi, gj)] : 0.0f;
    }
  }
}

__device__ void load_window(float* dst, const float* __restrict__ src,
                            int S, int r0, int c0, int w) {
  load_window(dst, src, SquareGeom{S, 0}, r0, c0, w);
}

// Runs `steps` smoothing steps on the window; returns the buffer that holds
// the result (the other one is free).  `first_step` is the global index of
// the launch's first step: RB-GS half-step j updates colour j % 2, so a
// smoothing split over several launches carries its colours on.  Only the
// geometry's live cells change (Jacobi zeroes the others).  The outermost
// ring has no neighbours and keeps its value: it is invalid after the first
// step.
template <typename Geom>
__device__ float* smooth_window(float* v, float* spare, const float* bw,
                                int w, int r0, int c0, const Geom& g,
                                int steps, int first_step, int rbgs,
                                const Weights& wt) {
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
          if (g.live(gi, gj) && g.color(gi, gj) == color) {
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
            out = g.live(gi, gj) ? c1 * v[k] + c2 * (bw[k] + nbr(v, k, w))
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

// The Dirichlet step loop (the mask needs only n).
__device__ float* smooth_window(float* v, float* spare, const float* bw,
                                int w, int r0, int c0, int n, int steps,
                                int first_step, int rbgs, const Weights& wt) {
  return smooth_window(v, spare, bw, w, r0, c0, SquareGeom{0, n}, steps,
                       first_step, rbgs, wt);
}

// Runs `steps` steps of a pointwise operator `op` on the window, each from
// the state before it into the other buffer, and returns the buffer that
// holds the result (the other one is free): op.step(v, bw, k, w) at the
// geometry's live cells, 0 at the other inner cells.  The outermost ring has
// no neighbours and keeps its value: it is invalid after the first step.
// The FAS kernels run their nonlinear Jacobi-Newton and Picard-Jacobi steps
// here, on the padded level (fas.cu) and on ghost-extended blocks
// (localfas.cu).
template <typename Op, typename Geom>
__device__ float* smooth_window_op(float* v, float* spare, const float* bw,
                                   int w, int r0, int c0, const Geom& g,
                                   int steps, const Op& op) {
  for (int s = 0; s < steps; ++s) {
    for (int li = threadIdx.y; li < w; li += blockDim.y) {
      const int gi = r0 + li;
      for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
        const int gj = c0 + lj;
        const int k = li * w + lj;
        float out = v[k];
        if (li > 0 && li < w - 1 && lj > 0 && lj < w - 1) {
          out = g.live(gi, gj) ? op.step(v, bw, k, w) : 0.0f;
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
