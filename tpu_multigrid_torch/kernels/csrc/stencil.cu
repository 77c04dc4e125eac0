// The streaming smoother: `steps` Jacobi (per-step weights) or red-black
// Gauss-Seidel steps of the 5-point Poisson stencil, optionally followed by
// the residual r = b - A u', in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_multigrid/kernels/stencil.py::_streamed
// (entries jacobi_sweeps, jacobi_sweeps_residual, rbgs_sweeps,
// rbgs_sweeps_residual and residual).
//
// What bounds it: device-memory traffic.  It reads u and b and writes u'
// (and r): 3 or 4 passes of S*S*4 bytes, against 8*steps + 6 flops per node.
// Unfused, every step and the residual would each be passes of their own.
//
// What the design does about it: K1's window (window.cuh).  One block per
// 64x64 output tile loads the tile plus a halo of `steps` rings (one more
// when the residual is fused) into shared memory, runs every step there and
// writes only u' (and r).  A launch takes at most kMaxSteps steps; the
// wrapper splits deeper smoothing into several launches, passing each the
// global index of its first step so that the RB-GS colours carry on, and
// fuses the residual into the last one only.
//
// Arithmetic: the same operations in the same order as core/ops.py's
// jacobi_sweeps, redblack_gs_sweeps and residual, built with -fmad=false:
// u' and r match the plain versions bitwise.

#include "window.cuh"

namespace {

// Steps per launch: keeps the window at (64 + 2 * 17)^2 floats x 3, 115 KB.
constexpr int kMaxSteps = 16;

__global__ void __launch_bounds__(kThreads)
streamed_kernel(const float* __restrict__ u, const float* __restrict__ b,
                float* __restrict__ u_out, float* __restrict__ r_out, int S,
                int n, int steps, int first_step, int rbgs, Weights wt) {
  extern __shared__ float smem[];
  const int halo = steps + (r_out != nullptr ? 1 : 0);
  const int w = kTile + 2 * halo;
  const int ro = blockIdx.y * kTile;
  const int co = blockIdx.x * kTile;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  float* buf_a = smem;
  float* buf_b = smem + w * w;
  float* bw = smem + 2 * w * w;
  load_window(buf_a, u, S, r0, c0, w);
  load_window(bw, b, S, r0, c0, w);
  __syncthreads();

  const float* v = smooth_window(buf_a, buf_b, bw, w, r0, c0, n, steps,
                                 first_step, rbgs, wt);

  for (int ti = threadIdx.y; ti < kTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (gi >= S || gj >= S) continue;
      const int k = (ti + halo) * w + tj + halo;
      const size_t g = (size_t)gi * S + gj;
      if (u_out != nullptr) u_out[g] = v[k];
      if (r_out != nullptr) {
        r_out[g] = is_interior(gi, gj, n) ? residual_at(v, bw, k, w) : 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

int tmt_stencil_max_steps(void) { return kMaxSteps; }

// One launch of 0..kMaxSteps steps.  u_out or r_out may be null (not
// written); with r_out the residual of the result is fused.  weights: host
// array [c1[0..count), c2[0..count)], local step s using entry s % count;
// ignored for RB-GS, whose half-step s updates colour (first_step + s) % 2.
int tmt_streamed(const void* u, const void* b, void* u_out, void* r_out,
                 int S, int n, int steps, int first_step, int rbgs,
                 const void* weights, int count, void* stream) {
  static int configured[kMaxDevices] = {};
  if (steps < 0 || steps > kMaxSteps) return cudaErrorInvalidValue;
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const int bytes = window_bytes(steps + (r_out != nullptr ? 1 : 0));
  err = allow_smem(streamed_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTile - 1) / kTile;
  streamed_kernel<<<dim3(tiles, tiles), dim3(kThreadsX, kThreadsY), bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<float*>(u_out), static_cast<float*>(r_out), S, n, steps,
      first_step, rbgs, wt);
  return cudaGetLastError();
}

}  // extern "C"
