// The 3D streaming smoother: `steps` Jacobi (per-step weights) or red-black
// Gauss-Seidel steps of the 7-point Poisson stencil, optionally followed by
// the residual r = b - A u', in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_multigrid/kernels/stencil3d.py::
// _streamed3 (entries jacobi_sweeps3, jacobi_sweeps_residual3, rbgs_sweeps3,
// rbgs_sweeps_residual3 and residual3).
//
// What bounds it: device-memory traffic.  It reads u and b and writes u'
// (and r): 3 or 4 passes of Sz*Sy*Sx*4 bytes, against ~10 flops per node and
// step.  Unfused, every step and the residual would be passes of their own.
//
// What the design does about it: the 3D window of window3.cuh.  One block
// per output tile loads u and b with a halo of `steps` layers (one more
// when the residual is fused), runs every step in shared memory and writes
// only u' (and r).  The halo costs redundant loads and steps (a 14^2 x 22
// tile in its 24^2 x 32 window at 3 steps + residual: 4.3 window cells per
// output), the price of one launch per smoothing.  A launch takes at most
// kMaxSteps3 steps; the wrapper splits deeper smoothing into launches,
// passing each the global index of its first step so that the RB-GS colours
// carry on, and fuses the residual into the last one only.
//
// Arithmetic: the Pallas kernel's order, as kernels/stencil3d.py's plain
// versions repeat it (window3.cuh): u' and r match them bitwise.

#include "window3.cuh"

namespace {

// Steps per launch: deeper smoothing is split (a halo of 4 + 1 keeps a
// 14^2 x 22 tile).
constexpr int kMaxSteps3 = 4;

__global__ void __launch_bounds__(kThreads3)
streamed3_kernel(const float* __restrict__ u, const float* __restrict__ b,
                 float* __restrict__ u_out, float* __restrict__ r_out,
                 Grid3 g, int steps, int first_step, int rbgs, Weights wt) {
  extern __shared__ float smem[];
  const int halo = steps + (r_out != nullptr ? 1 : 0);
  const int tyz = kW3yz - 2 * halo;
  const int tx = kW3x - 2 * halo;
  const int z0 = blockIdx.z * tyz - halo;
  const int y0 = blockIdx.y * tyz - halo;
  const int x0 = blockIdx.x * tx - halo;
  float* buf_a = smem;
  float* buf_b = smem + kW3Cells;
  float* bw = smem + 2 * kW3Cells;
  load_window3(buf_a, u, g, z0, y0, x0);
  load_window3(bw, b, g, z0, y0, x0);
  __syncthreads();

  ConstOp3<false> op;
  op.tp.count = 0;
  const float* v = smooth3(buf_a, buf_b, bw, z0, y0, x0, g.n, steps,
                           first_step, rbgs, wt, op);

  const int lx = threadIdx.x;
  const int gx = x0 + lx;
  if (lx < halo || lx >= halo + tx) return;
  for (int row = threadIdx.y; row < kW3Rows; row += blockDim.y) {
    int lz, ly;
    row_coords(row, lz, ly);
    if (lz < halo || lz >= halo + tyz || ly < halo || ly >= halo + tyz) {
      continue;
    }
    const int gz = z0 + lz;
    const int gy = y0 + ly;
    if (!in_array3(g, gz, gy, gx)) continue;
    const int k = row * kW3x + lx;
    const size_t o = gidx(g, gz, gy, gx);
    if (u_out != nullptr) u_out[o] = v[k];
    if (r_out != nullptr) {
      r_out[o] = interior3(gz, gy, gx, g.n)
                     ? op.residual(v, bw, k, gz, gy, gx)
                     : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

int tmt_stencil3d_max_steps(void) { return kMaxSteps3; }

// One launch of 0..kMaxSteps3 steps.  u_out or r_out may be null (not
// written); with r_out the residual of the result is fused.  weights: host
// array [c1[0..count), c2[0..count)], local step s using entry s % count;
// RB-GS uses c2[0] and updates colour (first_step + s) % 2 at half-step s.
int tmt_streamed3(const void* u, const void* b, void* u_out, void* r_out,
                  int Sz, int Sy, int Sx, int n, int steps, int first_step,
                  int rbgs, const void* weights, int count, void* stream) {
  static int configured[kMaxDevices] = {};
  if (steps < 0 || steps > kMaxSteps3) return cudaErrorInvalidValue;
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  err = allow_smem(streamed3_kernel, kWindow3Bytes, configured);
  if (err != cudaSuccess) return err;
  const int halo = steps + (r_out != nullptr ? 1 : 0);
  const int tyz = kW3yz - 2 * halo;
  const dim3 grid(tiles(Sx, kW3x - 2 * halo), tiles(Sy, tyz), tiles(Sz, tyz));
  streamed3_kernel<<<grid, dim3(kW3x, kThreads3Y), kWindow3Bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<float*>(u_out), static_cast<float*>(r_out),
      Grid3{Sz, Sy, Sx, n}, steps, first_step, rbgs, wt);
  return cudaGetLastError();
}

}  // extern "C"
