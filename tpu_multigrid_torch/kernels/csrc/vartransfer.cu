// K1v (var_smooth_restrict_fused) and K2v (var_prolong_smooth_fused,
// var_prolong_smooth_resnorm): the two kernels of a variable-coefficient
// multigrid level visit, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/vartransfer.py::
// _var_smooth_restrict (K1v) and ::_var_prolong_smooth (K2v).
//
//   K1v: `steps` var-stencil Jacobi or RB-GS steps on u, then the residual
//        r = (b - diag u) - off(u), then full-weighting restriction of r,
//        masked to the coarse interior (so zero past S/2).  Writes u', rc.
//   K2v: u <- mask(u + P ec) with bilinear P, then `steps` smoothing steps.
//        Writes u'; the resnorm variant also writes one partial sum of
//        (b - A u')^2 per block, which a one-block kernel adds up.
//
// What bounds them: device-memory traffic.  K1v reads u, b and 5 (or 9)
// coefficient planes and writes u' and the quarter-size rc; K2v reads u, b,
// the planes and the quarter-size ec and writes u': about 8.3 passes of
// S*S*4 bytes with 5 planes, against ~40 flops per node per step.
//
// What the design does about it: the var-stencil window (varwindow.cuh) of a
// 32x32 fine tile at an even origin, so its 16x16 coarse tile is aligned
// too, with a halo of steps + 2 rings (K1v: the residual and the restriction
// need two more) or steps + 1 (K2v: the resnorm needs one).  The residual and
// the correction never touch device memory.  The restriction and the
// prolongation are K1's and K2's (levelvisit.cuh), so they round as the
// port's ops.restrict_fw and ops.prolong do.  The resnorm partials are summed
// in a fixed order with no atomics.
//
// Arithmetic: bitwise equal to the plain versions in kernels/vartransfer.py
// (-fmad=false), except the resnorm's sum, which is taken in another order.

#include "levelvisit.cuh"
#include "varwindow.cuh"

namespace {

template <int NP>
__global__ void __launch_bounds__(kThreads)
var_smooth_restrict_kernel(const float* __restrict__ u,
                           const float* __restrict__ b,
                           const float* __restrict__ coef,
                           float* __restrict__ u_out, float* __restrict__ rc,
                           int S, int Sc, int n, int steps, int rbgs,
                           Weights wt) {
  extern __shared__ float smem[];
  const int halo = steps + 2;
  const int w = kVarTile + 2 * halo;
  const int ww = w * w;
  const int ro = blockIdx.y * kVarTile;
  const int co = blockIdx.x * kVarTile;
  const int cr0 = ro / 2;
  const int cc0 = co / 2;
  const int ct = kVarTile / 2;
  const int nc = n / 2;

  if (ro >= S || co >= S) {
    // Coarse tail past S/2: no fine tile maps here; it stays zero.
    for (int ci = threadIdx.y; ci < ct; ci += blockDim.y) {
      for (int cj = threadIdx.x; cj < ct; cj += blockDim.x) {
        const int I = cr0 + ci;
        const int J = cc0 + cj;
        if (I < Sc && J < Sc) rc[(size_t)I * Sc + J] = 0.0f;
      }
    }
    return;
  }

  float* buf_a = smem;
  float* buf_b = smem + ww;
  float* bw = smem + 2 * ww;
  float* invd = smem + 3 * ww;
  float* c = smem + 4 * ww;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  load_window(buf_a, u, S, r0, c0, w);
  load_window(bw, b, S, r0, c0, w);
  load_coef_windows<NP>(c, invd, coef, S, r0, c0, w);
  __syncthreads();

  float* v = var_smooth_window<NP>(buf_a, buf_b, bw, c, invd, w, r0, c0, n,
                                   steps, rbgs, wt);
  float* r = (v == buf_a) ? buf_b : buf_a;

  for (int ti = threadIdx.y; ti < kVarTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kVarTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (gi < S && gj < S) {
        u_out[(size_t)gi * S + gj] = v[(ti + halo) * w + tj + halo];
      }
    }
  }

  // Residual on the tile plus one ring: what the restriction reads.
  for (int li = halo - 1 + threadIdx.y; li <= halo + kVarTile;
       li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = halo - 1 + threadIdx.x; lj <= halo + kVarTile;
         lj += blockDim.x) {
      const int gj = c0 + lj;
      const int k = li * w + lj;
      r[k] = is_interior(gi, gj, n) ? var_residual_at<NP>(v, bw, c, k, w)
                                    : 0.0f;
    }
  }
  __syncthreads();

  // Full weighting at the tile's even nodes: blur along rows, then columns.
  for (int ci = threadIdx.y; ci < ct; ci += blockDim.y) {
    const int I = cr0 + ci;
    for (int cj = threadIdx.x; cj < ct; cj += blockDim.x) {
      const int J = cc0 + cj;
      if (I >= Sc || J >= Sc) continue;
      float val = 0.0f;
      if (I >= 1 && I <= nc - 1 && J >= 1 && J <= nc - 1) {
        const int k = (2 * ci + halo) * w + 2 * cj + halo;
        val = row_blur(r, k) + 0.5f * (row_blur(r, k - w) + row_blur(r, k + w));
      }
      rc[(size_t)I * Sc + J] = val;
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
var_prolong_smooth_kernel(const float* __restrict__ u,
                          const float* __restrict__ b,
                          const float* __restrict__ ec,
                          const float* __restrict__ coef,
                          float* __restrict__ u_out,
                          float* __restrict__ partials, int S, int Sc, int n,
                          int steps, int rbgs, Weights wt) {
  extern __shared__ float smem[];
  const int halo = steps + 1;
  const int w = kVarTile + 2 * halo;
  const int ww = w * w;
  const int ro = blockIdx.y * kVarTile;
  const int co = blockIdx.x * kVarTile;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  const int m = min(Sc, (S + 1) / 2);
  float* buf_a = smem;
  float* buf_b = smem + ww;
  float* bw = smem + 2 * ww;
  float* invd = smem + 3 * ww;
  float* c = smem + 4 * ww;

  for (int li = threadIdx.y; li < w; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
      const int gj = c0 + lj;
      const int k = li * w + lj;
      const bool in_array = gi >= 0 && gi < S && gj >= 0 && gj < S;
      buf_a[k] = is_interior(gi, gj, n)
                     ? u[(size_t)gi * S + gj] + prolong_at(ec, Sc, m, gi, gj)
                     : 0.0f;
      bw[k] = in_array ? b[(size_t)gi * S + gj] : 0.0f;
    }
  }
  load_coef_windows<NP>(c, invd, coef, S, r0, c0, w);
  __syncthreads();

  float* v = var_smooth_window<NP>(buf_a, buf_b, bw, c, invd, w, r0, c0, n,
                                   steps, rbgs, wt);

  float acc = 0.0f;
  for (int ti = threadIdx.y; ti < kVarTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kVarTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (gi >= S || gj >= S) continue;
      const int k = (ti + halo) * w + tj + halo;
      u_out[(size_t)gi * S + gj] = v[k];
      if (partials != nullptr && is_interior(gi, gj, n)) {
        const float rr = var_residual_at<NP>(v, bw, c, k, w);
        acc += rr * rr;
      }
    }
  }
  if (partials != nullptr) {
    float* red = (v == buf_a) ? buf_b : buf_a;
    const float total = block_sum(acc, red);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
    }
  }
}

struct VarArgs {
  const float* u;
  const float* b;
  const float* ec;
  const float* coef;
  float* u_out;
  float* rc_or_partials;
  int S, Sc, n, steps, rbgs;
};

template <int NP>
cudaError_t launch_smooth_restrict(const VarArgs& a, const Weights& wt,
                                   int bytes, cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(var_smooth_restrict_kernel<NP>, bytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (2 * a.Sc + kVarTile - 1) / kVarTile;
  var_smooth_restrict_kernel<NP>
      <<<dim3(tiles, tiles), dim3(kThreadsX, kThreadsY), bytes, stream>>>(
          a.u, a.b, a.coef, a.u_out, a.rc_or_partials, a.S, a.Sc, a.n,
          a.steps, a.rbgs, wt);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_prolong_smooth(const VarArgs& a, const Weights& wt,
                                  int bytes, cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(var_prolong_smooth_kernel<NP>, bytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (a.S + kVarTile - 1) / kVarTile;
  var_prolong_smooth_kernel<NP>
      <<<dim3(tiles, tiles), dim3(kThreadsX, kThreadsY), bytes, stream>>>(
          a.u, a.b, a.ec, a.coef, a.u_out, a.rc_or_partials, a.S, a.Sc, a.n,
          a.steps, a.rbgs, wt);
  return cudaGetLastError();
}

cudaError_t check_args(int nplanes, int steps, int halo, const void* weights,
                       int count, Weights* wt) {
  if (nplanes != 5 && nplanes != 9) return cudaErrorInvalidValue;
  if (steps < 0 || halo > var_max_halo(nplanes)) return cudaErrorInvalidValue;
  return make_weights(static_cast<const float*>(weights), count, wt);
}

}  // namespace

extern "C" {

// weights: host array [1 - w[0..count), w[0..count)], ignored for RB-GS.
// Grid covers 2*Sc (>= S) so that the coarse tail past S/2 is zeroed too.
int tmt_var_smooth_restrict(const void* u, const void* b, const void* coef,
                            void* u_out, void* rc, int S, int Sc, int n,
                            int steps, int rbgs, int nplanes,
                            const void* weights, int count, void* stream) {
  Weights wt;
  cudaError_t err = check_args(nplanes, steps, steps + 2, weights, count, &wt);
  if (err != cudaSuccess) return err;
  const VarArgs a{static_cast<const float*>(u), static_cast<const float*>(b),
                  nullptr, static_cast<const float*>(coef),
                  static_cast<float*>(u_out), static_cast<float*>(rc),
                  S, Sc, n, steps, rbgs};
  const int bytes = var_window_bytes(nplanes, steps + 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nplanes == 5 ? launch_smooth_restrict<5>(a, wt, bytes, st)
                      : launch_smooth_restrict<9>(a, wt, bytes, st);
}

// partials: (S / tile rounded up)^2 floats, or null for no resnorm; then
// out_sum[0] receives the sum of (b - A u')^2 over the interior.
int tmt_var_prolong_smooth(const void* u, const void* b, const void* ec,
                           const void* coef, void* u_out, void* partials,
                           void* out_sum, int S, int Sc, int n, int steps,
                           int rbgs, int nplanes, const void* weights,
                           int count, void* stream) {
  Weights wt;
  cudaError_t err = check_args(nplanes, steps, steps + 1, weights, count, &wt);
  if (err != cudaSuccess) return err;
  const VarArgs a{static_cast<const float*>(u), static_cast<const float*>(b),
                  static_cast<const float*>(ec),
                  static_cast<const float*>(coef),
                  static_cast<float*>(u_out), static_cast<float*>(partials),
                  S, Sc, n, steps, rbgs};
  const int bytes = var_window_bytes(nplanes, steps + 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = nplanes == 5 ? launch_prolong_smooth<5>(a, wt, bytes, st)
                     : launch_prolong_smooth<9>(a, wt, bytes, st);
  if (err != cudaSuccess || partials == nullptr) return err;
  const int tiles = (S + kVarTile - 1) / kVarTile;
  sum_partials_kernel<<<1, dim3(kThreadsX, kThreadsY), 0, st>>>(
      static_cast<const float*>(partials), tiles * tiles,
      static_cast<float*>(out_sum));
  return cudaGetLastError();
}

}  // extern "C"
