// K1f (fas_smooth_restrict) and K2f (fas_prolong_smooth, fas_prolong_
// smooth_resnorm): the two kernels of a 2D FAS (Full Approximation Scheme)
// level visit, for Hopper (sm_90a), on the pointwise family N(u) = A u +
// h^2 phi(u) (5-point A, Jacobi-Newton) and the quasilinear flux family
// N(u) = sum_e a(mid_e)(u - u_e) (Picard-Jacobi), with the nonlinearities
// of fasnl.cuh (the operator policies of fasop2.cuh).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/fas.py::
// _fas_smooth_restrict (K1f) and ::_fas_prolong_smooth (K2f), behind both
// families' entries (fas_* and qfas_*).
//
//   K1f: `steps` nonlinear smoothing steps on u, the nonlinear residual
//        r = b - N(u'), the solution injection uc0 = u'[2I, 2J] and the FAS
//        coarse right-hand side bc = N_c(uc0) + FW(r), both masked to the
//        coarse interior (zero past S/2).  Writes u', uc0 and bc.
//   K2f: u <- mask(u + P ec) with bilinear P, then `steps` smoothing steps.
//        Writes u'; the resnorm variant also writes one partial sum of
//        (b - N(u'))^2 per block, which a second one-block kernel adds up.
//
// What bounds them: device-memory traffic, as for K1/K2 (transfer.cu): K1f
// reads u and b and writes u' and two quarter-size coarse grids (~3.5
// passes of S*S*4 bytes), K2f ~3.3 passes.  A step costs ~12 flops and one
// expf per node (Bratu) or four coefficient evaluations (quadratic), still
// far below the card's flop-per-byte balance.
//
// What the design does about it: K1/K2's ghost-zone temporal blocking (one
// block per 64x64 fine tile, the tile plus a halo in shared memory, every
// step run there).  K1f's halo is steps + 2 rings, K1's: FW(r) at the
// tile's edge reads r one ring out, and r reads u' one ring further; the
// coarse apply at the tile's first even node reads uc0 one coarse node out,
// which is u' two fine rings out.  K2f's halo is steps + 1.  N_c is
// evaluated in shared memory on u' at the even nodes, so the coarse apply
// of the unfused path is no pass of its own.
//
// Arithmetic: the Pallas kernels' order, which kernels/fas.py's plain
// versions repeat: the Jacobi-Newton step forms ap = (diag u - nbr(u)) +
// h^2 phi(u) and u + (omega (b - ap)) / (diag + h^2 phi(u)); the Picard step
// sums the four edges (j+1, j-1, i+1, i-1) and divides by the guarded
// frozen diagonal where(d > 0, d, 1); both with IEEE division.  FW and P
// are K1/K2's (levelvisit.cuh).  Built with -fmad=false: u', uc0 and bc
// match the plain versions bitwise wherever torch's exp and expf agree.

#include "fasop2.cuh"
#include "levelvisit.cuh"
#include "window.cuh"

namespace {

template <typename Op>
__global__ void __launch_bounds__(kThreads)
fas_smooth_restrict_kernel(const float* __restrict__ u,
                           const float* __restrict__ b,
                           float* __restrict__ u_out,
                           float* __restrict__ uc_out,
                           float* __restrict__ bc_out, int S, int Sc, int n,
                           int steps, Op op) {
  extern __shared__ float smem[];
  const int halo = steps + 2;
  const int w = kTile + 2 * halo;
  const int ro = blockIdx.y * kTile;
  const int co = blockIdx.x * kTile;
  const int cr0 = ro / 2;
  const int cc0 = co / 2;
  const int ct = kTile / 2;
  const int nc = n / 2;

  if (ro >= S || co >= S) {
    // Coarse tail past S/2: no fine tile maps here; it stays zero.
    for (int ci = threadIdx.y; ci < ct; ci += blockDim.y) {
      for (int cj = threadIdx.x; cj < ct; cj += blockDim.x) {
        const int I = cr0 + ci;
        const int J = cc0 + cj;
        if (I < Sc && J < Sc) {
          uc_out[(size_t)I * Sc + J] = 0.0f;
          bc_out[(size_t)I * Sc + J] = 0.0f;
        }
      }
    }
    return;
  }

  float* buf_a = smem;
  float* buf_b = smem + w * w;
  float* bw = smem + 2 * w * w;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  load_window(buf_a, u, S, r0, c0, w);
  load_window(bw, b, S, r0, c0, w);
  __syncthreads();

  const float* v = smooth_window_op(buf_a, buf_b, bw, w, r0, c0,
                                    SquareGeom{0, n}, steps, op);
  float* r = (v == buf_a) ? buf_b : buf_a;

  for (int ti = threadIdx.y; ti < kTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (gi < S && gj < S) {
        u_out[(size_t)gi * S + gj] = v[(ti + halo) * w + tj + halo];
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
      r[k] = is_interior(gi, gj, n) ? op.residual(v, bw, k, w) : 0.0f;
    }
  }
  __syncthreads();

  // At the tile's even nodes: uc0, and bc = N_c(uc0) + FW(r).
  for (int ci = threadIdx.y; ci < ct; ci += blockDim.y) {
    const int I = cr0 + ci;
    for (int cj = threadIdx.x; cj < ct; cj += blockDim.x) {
      const int J = cc0 + cj;
      if (I >= Sc || J >= Sc) continue;
      float uc0 = 0.0f;
      float bc = 0.0f;
      if (is_interior(I, J, nc)) {
        const int k = (2 * ci + halo) * w + 2 * cj + halo;
        const float rc =
            row_blur(r, k) + 0.5f * (row_blur(r, k - w) + row_blur(r, k + w));
        uc0 = v[k];
        auto c = [&](int di, int dj) {
          return is_interior(I + di, J + dj, nc) ? v[k + 2 * (di * w + dj)]
                                                 : 0.0f;
        };
        bc = op.capply(uc0, c) + rc;
      }
      uc_out[(size_t)I * Sc + J] = uc0;
      bc_out[(size_t)I * Sc + J] = bc;
    }
  }
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
fas_prolong_smooth_kernel(const float* __restrict__ u,
                          const float* __restrict__ b,
                          const float* __restrict__ ec,
                          float* __restrict__ u_out,
                          float* __restrict__ partials, int S, int Sc, int n,
                          int steps, Op op) {
  extern __shared__ float smem[];
  const int halo = steps + 1;
  const int w = kTile + 2 * halo;
  const int ro = blockIdx.y * kTile;
  const int co = blockIdx.x * kTile;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  const int m = min(Sc, (S + 1) / 2);
  float* buf_a = smem;
  float* buf_b = smem + w * w;
  float* bw = smem + 2 * w * w;

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
  __syncthreads();

  const float* v = smooth_window_op(buf_a, buf_b, bw, w, r0, c0,
                                    SquareGeom{0, n}, steps, op);

  float acc = 0.0f;
  for (int ti = threadIdx.y; ti < kTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (gi >= S || gj >= S) continue;
      const int k = (ti + halo) * w + tj + halo;
      u_out[(size_t)gi * S + gj] = v[k];
      if (partials != nullptr && is_interior(gi, gj, n)) {
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
cudaError_t launch_k1f(const float* u, const float* b, float* u_out,
                       float* uc, float* bc, int S, int Sc, int n, int steps,
                       const Op& op, cudaStream_t st) {
  static int configured[kMaxDevices] = {};
  const int bytes = window_bytes(steps + 2);
  cudaError_t err = allow_smem(fas_smooth_restrict_kernel<Op>, bytes,
                               configured);
  if (err != cudaSuccess) return err;
  const int tiles = (2 * Sc + kTile - 1) / kTile;
  fas_smooth_restrict_kernel<Op><<<dim3(tiles, tiles),
                                   dim3(kThreadsX, kThreadsY), bytes, st>>>(
      u, b, u_out, uc, bc, S, Sc, n, steps, op);
  return cudaGetLastError();
}

template <typename Op>
cudaError_t launch_k2f(const float* u, const float* b, const float* ec,
                       float* u_out, float* partials, float* out_sum, int S,
                       int Sc, int n, int steps, const Op& op,
                       cudaStream_t st) {
  static int configured[kMaxDevices] = {};
  const int bytes = window_bytes(steps + 1);
  cudaError_t err = allow_smem(fas_prolong_smooth_kernel<Op>, bytes,
                               configured);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTile - 1) / kTile;
  fas_prolong_smooth_kernel<Op><<<dim3(tiles, tiles),
                                  dim3(kThreadsX, kThreadsY), bytes, st>>>(
      u, b, ec, u_out, partials, S, Sc, n, steps, op);
  err = cudaGetLastError();
  if (err != cudaSuccess || partials == nullptr) return err;
  sum_partials_kernel<<<1, dim3(kThreadsX, kThreadsY), 0, st>>>(
      partials, tiles * tiles, out_sum);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: kKindBratu (scalar = lam) or kKindQuadratic (scalar = gamma).
// Grid covers 2*Sc (>= S) so that the coarse tail past S/2 is zeroed too.
int tmt_fas_smooth_restrict(const void* u, const void* b, void* u_out,
                            void* uc, void* bc, int S, int Sc, int n,
                            int steps, int kind, float scalar, float omega,
                            float h2, float diag, void* stream) {
  const FasScalars s{scalar, omega, h2, 4.0f * h2, diag};
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  float* out = static_cast<float*>(u_out);
  float* ucc = static_cast<float*>(uc);
  float* bcc = static_cast<float*>(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps < 0 || window_bytes(steps + 2) > kMaxSmemBytes) {
    return cudaErrorInvalidValue;
  }
  if (kind == kKindBratu) {
    return launch_k1f(uu, bb, out, ucc, bcc, S, Sc, n, steps, bratu_op2(s),
                      st);
  }
  if (kind == kKindQuadratic) {
    return launch_k1f(uu, bb, out, ucc, bcc, S, Sc, n, steps,
                      quadratic_op2(s), st);
  }
  return cudaErrorInvalidValue;
}

// partials: (S/kTile rounded up)^2 floats, or null for no resnorm; then
// out_sum[0] receives the sum of (b - N(u'))^2 over the interior.
int tmt_fas_prolong_smooth(const void* u, const void* b, const void* ec,
                           void* u_out, void* partials, void* out_sum, int S,
                           int Sc, int n, int steps, int kind, float scalar,
                           float omega, float h2, float diag, void* stream) {
  const FasScalars s{scalar, omega, h2, 4.0f * h2, diag};
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  const float* cc = static_cast<const float*>(ec);
  float* out = static_cast<float*>(u_out);
  float* part = static_cast<float*>(partials);
  float* sum = static_cast<float*>(out_sum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps < 0 || window_bytes(steps + 1) > kMaxSmemBytes) {
    return cudaErrorInvalidValue;
  }
  if (kind == kKindBratu) {
    return launch_k2f(uu, bb, cc, out, part, sum, S, Sc, n, steps,
                      bratu_op2(s), st);
  }
  if (kind == kKindQuadratic) {
    return launch_k2f(uu, bb, cc, out, part, sum, S, Sc, n, steps,
                      quadratic_op2(s), st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
