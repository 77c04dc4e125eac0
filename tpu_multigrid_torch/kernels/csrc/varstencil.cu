// The variable-coefficient streaming smoother: `steps` Jacobi (per-step
// weights) or red-black Gauss-Seidel half-steps of a 9-point stencil with
// per-node coefficients, optionally followed by the residual of the result,
// in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_multigrid/kernels/varstencil.py::
// _var_streamed (entries var_smooth and var_smooth_residual).
//
// What bounds it: device-memory traffic.  It reads u, b and 5 coefficient
// planes (9 for a nonsymmetric operator) and writes u' (and r): 8 or 9
// passes of S*S*4 bytes with 5 planes, against ~40 flops per node per step.
//
// What the design does about it: one block per 32x32 output tile loads the
// tile plus a halo of `steps` rings (one more with the residual) of u, b and
// every coefficient plane into shared memory once (varwindow.cuh), runs every
// step there and writes only u' (and r), so the coefficients cross device
// memory once per launch however many steps run.  The tile is 32, not the
// constant-coefficient kernels' 64: with 4 + nplanes windows, a 64 tile at
// RB-GS(1,1) would take 8 x 72^2 x 4 B = 166 KB, one block per SM; a 32 tile
// takes 58 KB (5 planes), three blocks per SM.  The TPU gate
// (varstencil.py::supported) allows at most 6 steps on the grids it takes.
//
// Arithmetic: the TPU kernel's order (varwindow.cuh), built with -fmad=false:
// u' and r match the plain versions in kernels/varstencil.py bitwise.

#include "varwindow.cuh"

namespace {

template <int NP>
__global__ void __launch_bounds__(kThreads)
var_streamed_kernel(const float* __restrict__ u, const float* __restrict__ b,
                    const float* __restrict__ coef, float* __restrict__ u_out,
                    float* __restrict__ r_out, int S, int n, int steps,
                    int rbgs, Weights wt) {
  extern __shared__ float smem[];
  const int halo = steps + (r_out != nullptr ? 1 : 0);
  const int w = kVarTile + 2 * halo;
  const int ww = w * w;
  const int ro = blockIdx.y * kVarTile;
  const int co = blockIdx.x * kVarTile;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  float* buf_a = smem;
  float* buf_b = smem + ww;
  float* bw = smem + 2 * ww;
  float* invd = smem + 3 * ww;
  float* c = smem + 4 * ww;
  load_window(buf_a, u, S, r0, c0, w);
  load_window(bw, b, S, r0, c0, w);
  load_coef_windows<NP>(c, invd, coef, S, r0, c0, w);
  __syncthreads();

  const float* v = var_smooth_window<NP>(buf_a, buf_b, bw, c, invd, w, r0,
                                         c0, n, steps, rbgs, wt);

  for (int ti = threadIdx.y; ti < kVarTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kVarTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (gi >= S || gj >= S) continue;
      const int k = (ti + halo) * w + tj + halo;
      const size_t g = (size_t)gi * S + gj;
      u_out[g] = v[k];
      if (r_out != nullptr) {
        r_out[g] = is_interior(gi, gj, n)
                       ? var_residual_at<NP>(v, bw, c, k, w)
                       : 0.0f;
      }
    }
  }
}

template <int NP>
cudaError_t launch_var_streamed(const float* u, const float* b,
                                const float* coef, float* u_out,
                                float* r_out, int S, int n, int steps,
                                int rbgs, const Weights& wt, int bytes,
                                cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  cudaError_t err = allow_smem(var_streamed_kernel<NP>, bytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kVarTile - 1) / kVarTile;
  var_streamed_kernel<NP><<<dim3(tiles, tiles), dim3(kThreadsX, kThreadsY),
                            bytes, stream>>>(u, b, coef, u_out, r_out, S, n,
                                             steps, rbgs, wt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tmt_var_tile(void) { return kVarTile; }

// The deepest halo a launch may use with `nplanes` coefficient planes: a
// launch takes at most this many steps (one fewer with a fused residual).
int tmt_var_max_halo(int nplanes) { return var_max_halo(nplanes); }

// u_out (S x S) after `steps` steps; r_out the residual of the result, or
// null.  coef: (nplanes, S, S), nplanes 5 or 9.  weights: host array
// [1 - w[0..count), w[0..count)], step s using entry s % count; ignored for
// RB-GS, whose half-step s updates colour s % 2.
int tmt_var_streamed(const void* u, const void* b, const void* coef,
                     void* u_out, void* r_out, int S, int n, int steps,
                     int rbgs, int nplanes, const void* weights, int count,
                     void* stream) {
  if (nplanes != 5 && nplanes != 9) return cudaErrorInvalidValue;
  const int halo = steps + (r_out != nullptr ? 1 : 0);
  if (steps < 0 || halo > var_max_halo(nplanes)) return cudaErrorInvalidValue;
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const int bytes = var_window_bytes(nplanes, halo);
  const float* uf = static_cast<const float*>(u);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(coef);
  float* uo = static_cast<float*>(u_out);
  float* rf = static_cast<float*>(r_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nplanes == 5) {
    return launch_var_streamed<5>(uf, bf, cf, uo, rf, S, n, steps, rbgs, wt,
                                  bytes, st);
  }
  return launch_var_streamed<9>(uf, bf, cf, uo, rf, S, n, steps, rbgs, wt,
                                bytes, st);
}

}  // extern "C"
