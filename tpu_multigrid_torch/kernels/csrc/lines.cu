// Zebra line relaxation for Hopper (sm_90a): the zebra_x smoother, K1z
// (zebra_smooth_restrict) and K2z (prolong_zebra_smooth, with or without the
// residual norm).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/lines.py::
// _zebra_streamed, ::_zebra_smooth_restrict (K1z) and ::_prolong_zebra_smooth
// (K2z).
//
//   half-sweep of parity p: for each interior row i of parity p, the
//        tridiagonal system along the row (d = c4, dl = c3, du = c5, rhs = b
//        minus the six off-line terms at their current values; the identity
//        outside the interior), solved by parallel cyclic reduction over the
//        whole padded row of length S in ceil(log2 S) steps; the solution is
//        written at the interior columns.  A sweep is parity 1, then 0.
//   K1z: the sweeps, then r = b - A u (three row terms, north + centre +
//        south), restricted by full weighting and masked to the coarse
//        interior.
//   K2z: u <- mask(u + P ec) with bilinear P, then the sweeps; the resnorm
//        variant sums (b - A u')^2 per row, and one block adds the rows.
//
// What bounds them: the PCR's shared-memory traffic and divisions, not
// device memory.  A half-sweep reads the 9 planes and b on half the rows and
// u on the other half; its PCR does ceil(log2 S) steps of 8 shared-memory
// reads, 4 writes and 2 divisions per element.
//
// What the design does about it: the TPU's row strips do not carry over (a
// strip with its halo and the PCR workspace does not fit in shared memory),
// so each half-sweep is one launch with one block per pair of rows.  The
// block holds its row's dl, d, du and rhs in shared memory (16 S bytes),
// each thread stages its elements' new values in registers between two
// barriers per step.  A half-sweep writes rows of parity p and reads only
// rows of parity 1 - p, so it runs in place; the first one of a call also
// copies the rows it does not solve.  K1z's residual and restriction and
// K2z's prolongation and resnorm are launches of their own.
//
// Arithmetic: the Pallas kernels' operations in their order (-fmad=false, IEEE
// division), bitwise equal to the plain versions in kernels/lines.py, except
// the resnorm's sum, which is taken in another order.

#include "levelvisit.cuh"

namespace {

constexpr int kLineSmemFloats = kMaxSmemBytes / (4 * sizeof(float));

int pcr_steps(int S) {
  int steps = 0;
  while ((1 << steps) < S) ++steps;
  return steps > 1 ? steps : 1;
}

// The threads of a line block: S / EPT rounded up to whole warps (EPT, the
// elements per thread, is 4, 8 or 16: at most 1024 threads up to S = 16384).
int line_threads(int S, int ept) {
  const int t = (S + ept - 1) / ept;
  return (t + 31) / 32 * 32;
}

// PCR on the block's line: ceil(log2 S) steps; step s reads the old values
// at j - s and j + s (fills 1 for d, 0 otherwise), then all threads write.
template <int EPT>
__device__ void pcr_line(float* dl, float* d, float* du, float* bb, int S,
                         int steps) {
  for (int k = 0; k < steps; ++k) {
    const int s = 1 << k;
    float nd[EPT], nb[EPT], ndl[EPT], ndu[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int j = threadIdx.x + e * blockDim.x;
      if (j < S) {
        const bool lo = j >= s;
        const bool hi = j + s < S;
        const float d_m = lo ? d[j - s] : 1.0f;
        const float d_p = hi ? d[j + s] : 1.0f;
        const float dl_m = lo ? dl[j - s] : 0.0f;
        const float du_m = lo ? du[j - s] : 0.0f;
        const float b_m = lo ? bb[j - s] : 0.0f;
        const float du_p = hi ? du[j + s] : 0.0f;
        const float dl_p = hi ? dl[j + s] : 0.0f;
        const float b_p = hi ? bb[j + s] : 0.0f;
        const float alpha = -dl[j] / d_m;
        const float beta = -du[j] / d_p;
        nd[e] = (d[j] + alpha * du_m) + beta * dl_p;
        nb[e] = (bb[j] + alpha * b_m) + beta * b_p;
        ndl[e] = alpha * dl_m;
        ndu[e] = beta * du_p;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int j = threadIdx.x + e * blockDim.x;
      if (j < S) {
        d[j] = nd[e];
        bb[j] = nb[e];
        dl[j] = ndl[e];
        du[j] = ndu[e];
      }
    }
    __syncthreads();
  }
}

__device__ void copy_row(const float* __restrict__ in, float* __restrict__ out,
                         int r, int S) {
  const size_t row = (size_t)r * S;
  for (int j = threadIdx.x; j < S; j += blockDim.x) out[row + j] = in[row + j];
}

// One half-sweep of parity p.  Block k owns rows 2k + p (solved when
// interior) and 2k + 1 - p; when in != out it copies what it does not solve.
template <int EPT>
__global__ void __launch_bounds__(1024)
zebra_half_kernel(const float* in, float* out, const float* __restrict__ b,
                  const float* __restrict__ coef, int S, int n, int parity,
                  int steps) {
  extern __shared__ float smem[];
  const int r = 2 * blockIdx.x + parity;
  const bool copy = in != out;
  if (copy) copy_row(in, out, 2 * blockIdx.x + 1 - parity, S);
  if (r < 1 || r > n - 1) {
    if (copy) copy_row(in, out, r, S);
    return;
  }
  float* dl = smem;
  float* d = smem + S;
  float* du = smem + 2 * S;
  float* bb = smem + 3 * S;
  const size_t SS = (size_t)S * S;
  const size_t row = (size_t)r * S;
  const float* north = in + row - S;
  const float* south = in + row + S;
  const float* c = coef + row;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const int jm = j == 0 ? S - 1 : j - 1;
    const int jp = j == S - 1 ? 0 : j + 1;
    float acc = 0.0f;
    acc = acc + c[j] * north[jm];
    acc = acc + c[SS + j] * north[j];
    acc = acc + c[2 * SS + j] * north[jp];
    acc = acc + c[6 * SS + j] * south[jm];
    acc = acc + c[7 * SS + j] * south[j];
    acc = acc + c[8 * SS + j] * south[jp];
    const float rhs = b[row + j] - acc;
    const bool inter = j >= 1 && j <= n - 1;
    d[j] = inter ? c[4 * SS + j] : 1.0f;
    dl[j] = inter ? c[3 * SS + j] : 0.0f;
    du[j] = inter ? c[5 * SS + j] : 0.0f;
    bb[j] = inter ? rhs : 0.0f;
  }
  __syncthreads();
  pcr_line<EPT>(dl, d, du, bb, S, steps);
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    if (j >= 1 && j <= n - 1) {
      out[row + j] = bb[j] / d[j];
    } else if (copy) {
      out[row + j] = in[row + j];
    }
  }
}

// b - A u at interior node (i, j), zero elsewhere: three row terms
// c_m x[j-1] + c_0 x[j] + c_p x[j+1], north + centre + south.
__device__ __forceinline__ float residual9_at(const float* __restrict__ u,
                                             const float* __restrict__ b,
                                             const float* __restrict__ coef,
                                             int S, int n, int i, int j) {
  if (!is_interior(i, j, n)) return 0.0f;
  const size_t SS = (size_t)S * S;
  const size_t k = (size_t)i * S + j;
  const float* c = coef + k;
  auto term = [&](int p, size_t x) {
    return (c[p * SS] * u[x - 1] + c[(p + 1) * SS] * u[x]) +
           c[(p + 2) * SS] * u[x + 1];
  };
  const float au = (term(0, k - S) + term(3, k)) + term(6, k + S);
  return b[k] - au;
}

// K1z's tail: one block per coarse row I.  The column sums (r[i-1] + 2 r[i])
// + r[i+1] of its three fine rows go to shared memory, then full weighting
// along the row: 0.25 ((t[j-1] + 2 t[j]) + t[j+1]).
__global__ void __launch_bounds__(kThreads)
zebra_restrict_kernel(const float* __restrict__ u, const float* __restrict__ b,
                      const float* __restrict__ coef, float* __restrict__ rc,
                      int S, int Sc, int n) {
  extern __shared__ float row3[];
  const int I = blockIdx.x;
  const int nc = n / 2;
  float* out = rc + (size_t)I * Sc;
  if (I < 1 || I > nc - 1) {
    for (int J = threadIdx.x; J < Sc; J += blockDim.x) out[J] = 0.0f;
    return;
  }
  const int i = 2 * I;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    row3[j] = (residual9_at(u, b, coef, S, n, i - 1, j) +
               2.0f * residual9_at(u, b, coef, S, n, i, j)) +
              residual9_at(u, b, coef, S, n, i + 1, j);
  }
  __syncthreads();
  for (int J = threadIdx.x; J < Sc; J += blockDim.x) {
    float val = 0.0f;
    if (J >= 1 && J <= nc - 1) {
      const int j = 2 * J;
      val = 0.25f * ((row3[j - 1] + 2.0f * row3[j]) + row3[j + 1]);
    }
    out[J] = val;
  }
}

// Bilinear prolongation at fine node (gi, gj) in the Pallas order: each
// coarse value fills a 2 x 2 block, rows average with the next row, then
// columns with the next column.  Coarse nodes past Sc read 0.
__device__ __forceinline__ float prolong_rows_cols(
    const float* __restrict__ ec, int Sc, int gi, int gj) {
  const int I = gi >> 1;
  const int J = gj >> 1;
  const int I2 = (gi & 1) ? I + 1 : I;
  auto c = [&](int a, int bb) {
    return (a < Sc && bb < Sc) ? __ldg(ec + (size_t)a * Sc + bb) : 0.0f;
  };
  auto rows = [&](int jj) { return 0.5f * (c(I, jj) + c(I2, jj)); };
  const float f0 = rows(J);
  const float f1 = (gj & 1) ? rows(J + 1) : f0;
  return 0.5f * (f0 + f1);
}

// K2z's head: u_out = mask(u + P ec).
__global__ void __launch_bounds__(kThreads)
zebra_prolong_kernel(const float* __restrict__ u, const float* __restrict__ ec,
                     float* __restrict__ u_out, int S, int Sc, int n) {
  const int gi = blockIdx.y * blockDim.y + threadIdx.y;
  const int gj = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= S || gj >= S) return;
  const size_t k = (size_t)gi * S + gj;
  u_out[k] = is_interior(gi, gj, n) ? u[k] + prolong_rows_cols(ec, Sc, gi, gj)
                                    : 0.0f;
}

// The resnorm's partial sums: row i's sum of r^2, in a fixed order.
__global__ void __launch_bounds__(kThreads)
zebra_resnorm_rows_kernel(const float* __restrict__ u,
                          const float* __restrict__ b,
                          const float* __restrict__ coef,
                          float* __restrict__ partials, int S, int n) {
  __shared__ float red[kThreads];
  const int i = blockIdx.x;
  float acc = 0.0f;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const float r = residual9_at(u, b, coef, S, n, i, j);
    acc += r * r;
  }
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) partials[i] = total;
}

template <int EPT>
cudaError_t launch_half(const float* in, float* out, const float* b,
                        const float* coef, int S, int n, int parity,
                        cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  const int bytes = 4 * S * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(zebra_half_kernel<EPT>, bytes, configured);
  if (err != cudaSuccess) return err;
  zebra_half_kernel<EPT><<<S / 2, line_threads(S, EPT), bytes, stream>>>(
      in, out, b, coef, S, n, parity, pcr_steps(S));
  return cudaGetLastError();
}

// `sweeps` sweeps from u into u_out: the first half-sweep copies, the rest
// run in place on u_out.
cudaError_t run_sweeps(const float* u, float* u_out, const float* b,
                       const float* coef, int S, int n, int sweeps,
                       cudaStream_t stream) {
  const float* in = u;
  for (int s = 0; s < sweeps; ++s) {
    for (int parity = 1; parity >= 0; --parity) {
      cudaError_t err =
          S <= 4 * 1024   ? launch_half<4>(in, u_out, b, coef, S, n, parity,
                                           stream)
          : S <= 8 * 1024 ? launch_half<8>(in, u_out, b, coef, S, n, parity,
                                           stream)
                          : launch_half<16>(in, u_out, b, coef, S, n, parity,
                                            stream);
      if (err != cudaSuccess) return err;
      in = u_out;
    }
  }
  return cudaSuccess;
}

cudaError_t check_line(int S, int sweeps) {
  if (S < 2 || S % 2 || S > kLineSmemFloats || S > 16 * 1024 || sweeps < 0) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The longest line one block holds.
int tmt_zebra_max_line() { return kLineSmemFloats; }

int tmt_zebra_sweeps(const void* u, const void* b, const void* coef,
                     void* u_out, int S, int n, int sweeps, void* stream) {
  cudaError_t err = check_line(S, sweeps);
  if (err != cudaSuccess) return err;
  return run_sweeps(static_cast<const float*>(u), static_cast<float*>(u_out),
                    static_cast<const float*>(b),
                    static_cast<const float*>(coef), S, n, sweeps,
                    static_cast<cudaStream_t>(stream));
}

// u_out may be u itself when sweeps is 0.
int tmt_zebra_smooth_restrict(const void* u, const void* b, const void* coef,
                              void* u_out, void* rc, int S, int Sc, int n,
                              int sweeps, void* stream) {
  cudaError_t err = check_line(S, sweeps);
  if (err != cudaSuccess) return err;
  if (2 * Sc < S) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(u_out);
  err = run_sweeps(static_cast<const float*>(u), v,
                   static_cast<const float*>(b),
                   static_cast<const float*>(coef), S, n, sweeps, st);
  if (err != cudaSuccess) return err;
  static int configured[kMaxDevices] = {};
  const int bytes = S * static_cast<int>(sizeof(float));
  err = allow_smem(zebra_restrict_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  zebra_restrict_kernel<<<Sc, kThreads, bytes, st>>>(
      v, static_cast<const float*>(b), static_cast<const float*>(coef),
      static_cast<float*>(rc), S, Sc, n);
  return cudaGetLastError();
}

// partials: S floats, or null for no resnorm; then out_sum[0] receives the
// sum of (b - A u')^2 over the interior.
int tmt_zebra_prolong_smooth(const void* u, const void* b, const void* ec,
                             const void* coef, void* u_out, void* partials,
                             void* out_sum, int S, int Sc, int n, int sweeps,
                             void* stream) {
  cudaError_t err = check_line(S, sweeps);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(u_out);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(coef);
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((S + kThreadsX - 1) / kThreadsX,
                  (S + kThreadsY - 1) / kThreadsY);
  zebra_prolong_kernel<<<grid, block, 0, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(ec), v, S, Sc,
      n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = run_sweeps(v, v, bf, cf, S, n, sweeps, st);
  if (err != cudaSuccess || partials == nullptr) return err;
  float* part = static_cast<float*>(partials);
  zebra_resnorm_rows_kernel<<<S, kThreads, 0, st>>>(v, bf, cf, part, S, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, block, 0, st>>>(part, S,
                                           static_cast<float*>(out_sum));
  return cudaGetLastError();
}

}  // extern "C"
