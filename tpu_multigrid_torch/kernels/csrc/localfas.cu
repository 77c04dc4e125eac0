// K1f-local (fas_smooth_restrict_ext, qfas_smooth_restrict_ext) and
// K2f-local (fas_prolong_smooth_ext, qfas_prolong_smooth_ext, with or
// without the owned resnorm): the two kernels of a FAS level visit on a
// ghost-extended block, for Hopper (sm_90a), on both families of fas.cu
// (the operator policies of fasop2.cuh, with the nonlinearities of
// fasnl.cuh).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/localfas.py::
// _k1f_local and ::_k2f_local.
//
// The block is local.cu's: an (R, C) = (lr + 2*GR, lc + 2*GC) array whose
// cell (i, j) has the global coordinates (o0 + i, o1 + j) (ExtGeom,
// window.cuh); the coarse blocks are (R/2 + GR, C/2 + GC), fine cell
// (i, j), both even, mapping to coarse cell (i/2 + GR/2, j/2 + GC/2).
//
//   K1f: `steps` nonlinear smoothing steps on u, the nonlinear residual
//        r = b - N(u') at the live cells, then at the even cells the
//        injection uc0 = u' and the FAS right-hand side bc = N_c(uc0) +
//        FW(r), both masked to the coarse interior in global coordinates
//        ((o0 + i)/2, (o1 + j)/2 floored, in 1..n/2-1).  Writes u' and the
//        two coarse blocks, zero outside the rows and columns the fine
//        block restricts to.
//   K2f: u <- where(live, u + P ec, 0), then `steps` smoothing steps.
//        Writes u'; the resnorm variant also writes one partial sum of
//        (b - N(u'))^2 over the owned live cells per block, which a
//        one-block kernel adds up in a fixed order.
//
// Every output is defined on the whole array: cells outside the array read
// as zero and are never updated, as in the plain versions (kernels/
// localfas.py), so the kernels match them bitwise everywhere, ghosts
// included.  The TPU kernels leave the ghost rings undefined; the two
// agree on the owned region, which is all a caller reads after refreshing
// the ghosts.
//
// What bounds them: device-memory traffic, as for K1-local / K2-local: u
// and b read, u' written, plus two quarter-size coarse blocks for K1f and
// one for K2f, about 3.5 and 3.3 passes of R*C*4 bytes; a step costs ~14
// flops and one expf a cell (Bratu) or ~41 flops (the quadratic
// coefficient), below the card's flop-per-byte balance.
//
// What the design does about it: local.cu's tiling with fas.cu's step
// loop.  One block per 64x64 fine tile loads the tile plus a halo of
// steps + 2 rings (K1f) or steps + 1 (K2f) into shared memory and runs
// every step there (smooth_window_op on ExtGeom).  K1f's halo covers FW(r)
// at the tile's edge, which reads r one ring out, and the coarse apply at
// the tile's first even cell, which reads uc0 one coarse cell out: u' two
// fine rings out.  N_c is evaluated on u' at the even cells in shared
// memory, so uc0 is read back from no pass of its own.
//
// Arithmetic: the Pallas kernels' operations in their order: the steps,
// the residual and N_c of fasop2.cuh (fas.cu's), the full-weighting
// aggregate of extvisit.cuh and the prolongation of ext.cuh (local.cu's),
// built with -fmad=false.

#include "extvisit.cuh"
#include "fasop2.cuh"
#include "levelvisit.cuh"
#include "window.cuh"

namespace {

template <typename Op>
__global__ void __launch_bounds__(kThreads)
fas_smooth_restrict_ext_kernel(const float* __restrict__ u,
                               const float* __restrict__ b,
                               float* __restrict__ u_out,
                               float* __restrict__ uc_out,
                               float* __restrict__ bc_out, ExtGeom g,
                               int steps, Op op) {
  extern __shared__ float smem[];
  const int halo = steps + 2;
  const int w = kTile + 2 * halo;
  const int ro = blockIdx.y * kTile;
  const int co = blockIdx.x * kTile;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  const int Cc = g.C / 2 + kGC;
  const int nc = g.n / 2;
  const int fo0 = floor_half(g.o0);
  const int fo1 = floor_half(g.o1);
  float* buf_a = smem;
  float* buf_b = smem + w * w;
  float* bw = smem + 2 * w * w;
  load_window(buf_a, u, g, r0, c0, w);
  load_window(bw, b, g, r0, c0, w);
  __syncthreads();

  const float* v = smooth_window_op(buf_a, buf_b, bw, w, r0, c0, g, steps,
                                    op);
  float* r = (v == buf_a) ? buf_b : buf_a;

  for (int ti = threadIdx.y; ti < kTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (g.in_array(gi, gj)) {
        u_out[g.at(gi, gj)] = v[(ti + halo) * w + tj + halo];
      }
    }
  }

  // The nonlinear residual on the tile plus one ring: what FW reads.
  for (int li = halo - 1 + threadIdx.y; li <= halo + kTile; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = halo - 1 + threadIdx.x; lj <= halo + kTile;
         lj += blockDim.x) {
      const int gj = c0 + lj;
      const int k = li * w + lj;
      r[k] = g.live(gi, gj) ? op.residual(v, bw, k, w) : 0.0f;
    }
  }
  __syncthreads();

  // At the tile's even cells: uc0 and bc = N_c(uc0) + FW(r).  A coarse
  // neighbour outside the coarse interior reads 0; one outside the array
  // reads u' outside the array, which is 0.
  const int ct = kTile / 2;
  for (int ci = threadIdx.y; ci < ct; ci += blockDim.y) {
    const int gi = ro + 2 * ci;
    for (int cj = threadIdx.x; cj < ct; cj += blockDim.x) {
      const int gj = co + 2 * cj;
      if (!g.in_array(gi, gj)) continue;
      const int hi = gi / 2 + fo0;
      const int hj = gj / 2 + fo1;
      float uc0 = 0.0f;
      float bc = 0.0f;
      if (is_interior(hi, hj, nc)) {
        const int k = (2 * ci + halo) * w + 2 * cj + halo;
        const float rc = fw_aggregate(r, k, w);
        uc0 = v[k];
        auto c = [&](int di, int dj) {
          return is_interior(hi + di, hj + dj, nc) ? v[k + 2 * (di * w + dj)]
                                                   : 0.0f;
        };
        bc = op.capply(uc0, c) + rc;
      }
      const size_t at = (size_t)(gi / 2 + kGR / 2) * Cc + gj / 2 + kGC / 2;
      uc_out[at] = uc0;
      bc_out[at] = bc;
    }
  }
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
fas_prolong_smooth_ext_kernel(const float* __restrict__ u,
                              const float* __restrict__ b,
                              const float* __restrict__ ec,
                              float* __restrict__ u_out,
                              float* __restrict__ partials, ExtGeom g,
                              int steps, Op op) {
  extern __shared__ float smem[];
  const int halo = steps + 1;
  const int w = kTile + 2 * halo;
  const int ro = blockIdx.y * kTile;
  const int co = blockIdx.x * kTile;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  const int Cc = g.C / 2 + kGC;
  float* buf_a = smem;
  float* buf_b = smem + w * w;
  float* bw = smem + 2 * w * w;

  for (int li = threadIdx.y; li < w; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
      const int gj = c0 + lj;
      const int k = li * w + lj;
      buf_a[k] = g.live(gi, gj)
                     ? u[g.at(gi, gj)] + prolong_ext(ec, Cc, gi, gj)
                     : 0.0f;
      bw[k] = g.in_array(gi, gj) ? b[g.at(gi, gj)] : 0.0f;
    }
  }
  __syncthreads();

  const float* v = smooth_window_op(buf_a, buf_b, bw, w, r0, c0, g, steps,
                                    op);

  float acc = 0.0f;
  for (int ti = threadIdx.y; ti < kTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (!g.in_array(gi, gj)) continue;
      const int k = (ti + halo) * w + tj + halo;
      u_out[g.at(gi, gj)] = v[k];
      const bool owned = gi >= kGR && gi < g.R - kGR && gj >= kGC &&
                         gj < g.C - kGC;
      if (partials != nullptr && owned && g.live(gi, gj)) {
        const float rr = op.residual(v, bw, k, w);
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

template <typename Op>
cudaError_t launch_k1f_ext(const float* u, const float* b, float* u_out,
                           float* uc, float* bc, const ExtGeom& g, int steps,
                           const Op& op, cudaStream_t st) {
  static int configured[kMaxDevices] = {};
  const int bytes = window_bytes(steps + 2);
  cudaError_t err = allow_smem(fas_smooth_restrict_ext_kernel<Op>, bytes,
                               configured);
  if (err != cudaSuccess) return err;
  fas_smooth_restrict_ext_kernel<Op><<<tile_grid(g.R, g.C),
                                       dim3(kThreadsX, kThreadsY), bytes,
                                       st>>>(u, b, u_out, uc, bc, g, steps,
                                             op);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = zero_frame(uc, g.R, g.C, st);
  if (err != cudaSuccess) return err;
  return zero_frame(bc, g.R, g.C, st);
}

template <typename Op>
cudaError_t launch_k2f_ext(const float* u, const float* b, const float* ec,
                           float* u_out, float* partials, float* out_sum,
                           const ExtGeom& g, int steps, const Op& op,
                           cudaStream_t st) {
  static int configured[kMaxDevices] = {};
  const int bytes = window_bytes(steps + 1);
  cudaError_t err = allow_smem(fas_prolong_smooth_ext_kernel<Op>, bytes,
                               configured);
  if (err != cudaSuccess) return err;
  const dim3 grid = tile_grid(g.R, g.C);
  fas_prolong_smooth_ext_kernel<Op><<<grid, dim3(kThreadsX, kThreadsY),
                                      bytes, st>>>(u, b, ec, u_out, partials,
                                                   g, steps, op);
  err = cudaGetLastError();
  if (err != cudaSuccess || partials == nullptr) return err;
  sum_partials_kernel<<<1, dim3(kThreadsX, kThreadsY), 0, st>>>(
      partials, grid.x * grid.y, out_sum);
  return cudaGetLastError();
}

bool ext_args_ok(int R, int C, int steps, int halo) {
  return R % 2 == 0 && C % 2 == 0 && steps >= 0 &&
         steps + 2 <= kGR && window_bytes(halo) <= kMaxSmemBytes;
}

}  // namespace

extern "C" {

// u, b, u_out: (R, C); uc, bc: (R/2 + GR, C/2 + GC).  kind: kKindBratu
// (scalar = lam) or kKindQuadratic (scalar = gamma); h2 and diag are the
// pointwise family's (unused by the quadratic one).
int tmt_fas_smooth_restrict_ext(const void* u, const void* b, void* u_out,
                                void* uc, void* bc, int R, int C, int o0,
                                int o1, int n, int steps, int kind,
                                float scalar, float omega, float h2,
                                float diag, void* stream) {
  if (!ext_args_ok(R, C, steps, steps + 2)) return cudaErrorInvalidValue;
  const FasScalars s{scalar, omega, h2, 4.0f * h2, diag};
  const ExtGeom g{R, C, o0, o1, n};
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  float* out = static_cast<float*>(u_out);
  float* ucc = static_cast<float*>(uc);
  float* bcc = static_cast<float*>(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kKindBratu) {
    return launch_k1f_ext(uu, bb, out, ucc, bcc, g, steps, bratu_op2(s), st);
  }
  if (kind == kKindQuadratic) {
    return launch_k1f_ext(uu, bb, out, ucc, bcc, g, steps, quadratic_op2(s),
                          st);
  }
  return cudaErrorInvalidValue;
}

// ec: (R/2 + GR, C/2 + GC).  partials: one float per 64x64 tile of (R, C),
// or null for no resnorm; then out_sum[0] receives the sum of
// (b - N(u'))^2 over the owned live cells.
int tmt_fas_prolong_smooth_ext(const void* u, const void* b, const void* ec,
                               void* u_out, void* partials, void* out_sum,
                               int R, int C, int o0, int o1, int n,
                               int steps, int kind, float scalar,
                               float omega, float h2, float diag,
                               void* stream) {
  if (!ext_args_ok(R, C, steps, steps + 1)) return cudaErrorInvalidValue;
  const FasScalars s{scalar, omega, h2, 4.0f * h2, diag};
  const ExtGeom g{R, C, o0, o1, n};
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  const float* cc = static_cast<const float*>(ec);
  float* out = static_cast<float*>(u_out);
  float* part = static_cast<float*>(partials);
  float* sum = static_cast<float*>(out_sum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kKindBratu) {
    return launch_k2f_ext(uu, bb, cc, out, part, sum, g, steps,
                          bratu_op2(s), st);
  }
  if (kind == kKindQuadratic) {
    return launch_k2f_ext(uu, bb, cc, out, part, sum, g, steps,
                          quadratic_op2(s), st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
