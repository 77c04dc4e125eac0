// K1 (smooth_restrict) and K2 (prolong_smooth, prolong_smooth_resnorm):
// the two kernels of a multigrid level visit, for Hopper (sm_90a); and the
// three standalone transfers restrict_fw, prolong_add and prolong_comp.
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/transfer.py::
// _smooth_restrict (K1), ::_prolong_smooth (K2), ::_restrict_only,
// ::_prolong_add_only and ::_prolong_comp_only.
//
// The standalone transfers serve the levels the fused pair does not: the
// double-single cycle (precision.cycle_ds) and FMG.  Each is one pass with
// no reuse beyond a node's neighbours: restrict_fw reads r and writes the
// quarter-size rc (1.25 passes of S*S*4 bytes), prolong_add reads u and the
// quarter-size ec and writes u' (2.25), prolong_comp reads ec and writes hi
// and err (2.25).  So each is one thread per output node, reading straight
// from device memory; neighbouring threads share their reads through L1/L2.
// prolong_comp's TwoSum goes through __fadd_rn/__fsub_rn (twosum.cuh).
//
//   K1: `steps` Jacobi (per-step weights) or red-black Gauss-Seidel steps
//       on u, then r = b - A u, then full-weighting restriction of r to the
//       coarse grid, masked to the coarse interior.  Writes u' and rc.
//   K2: u <- mask(u + P ec) with bilinear P, then `steps` smoothing steps.
//       Writes u'; the resnorm variant also writes one partial sum of
//       (b - A u')^2 per block, which a second one-block kernel adds up.
//
// What bounds them: device-memory traffic.  K1 reads u and b and writes u'
// and the quarter-size rc; K2 reads u, b and the quarter-size ec and writes
// u': about 3.3 passes of S*S*4 bytes each, against 8*steps + 16 flops per
// node, far below the card's flop-per-byte balance.  Run unfused, every
// sweep, the residual and each transfer would be passes of their own.
//
// What the design does about it: one block per 64x64 fine output tile, at an
// even origin so that its coarse tile is aligned too.  The block loads the
// tile plus a halo into shared memory once (steps + 2 rings for K1: each step
// invalidates one ring, the residual and the restriction need two more;
// steps + 1 for K2, whose resnorm needs one), runs every step there and
// writes only the outputs, so the sweeps cost no device-memory passes
// (ghost-zone temporal blocking).  Neighbouring blocks reload each other's
// halos, mostly from L2.
//
// Arithmetic: the same operations in the same order as the plain torch
// versions (tpu_multigrid_torch/core/ops.py), built with -fmad=false so that
// nothing is contracted into an FMA: u' and rc match the plain versions
// bitwise.  The resnorm partials are summed in a fixed tree order with no
// atomics, so the norm, and every until-tol decision made from it, repeats
// run to run.  Cells outside the array read as zero; the interior mask is
// taken from global indices, as in the plain versions.

#include "levelvisit.cuh"
#include "twosum.cuh"
#include "window.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
smooth_restrict_kernel(const float* __restrict__ u,
                       const float* __restrict__ b,
                       float* __restrict__ u_out, float* __restrict__ rc,
                       int S, int Sc, int n, int steps, int rbgs,
                       Weights wt) {
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
        if (I < Sc && J < Sc) rc[(size_t)I * Sc + J] = 0.0f;
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

  float* v = smooth_window(buf_a, buf_b, bw, w, r0, c0, n, steps, 0, rbgs,
                           wt);
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

  // Residual on the tile plus one ring: what the restriction reads.
  for (int li = halo - 1 + threadIdx.y; li <= halo + kTile; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = halo - 1 + threadIdx.x; lj <= halo + kTile;
         lj += blockDim.x) {
      const int gj = c0 + lj;
      const int k = li * w + lj;
      r[k] = is_interior(gi, gj, n) ? residual_at(v, bw, k, w) : 0.0f;
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

__global__ void __launch_bounds__(kThreads)
prolong_smooth_kernel(const float* __restrict__ u,
                      const float* __restrict__ b,
                      const float* __restrict__ ec,
                      float* __restrict__ u_out,
                      float* __restrict__ partials,
                      int S, int Sc, int n, int steps, int rbgs,
                      Weights wt) {
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

  float* v = smooth_window(buf_a, buf_b, bw, w, r0, c0, n, steps, 0, rbgs,
                           wt);

  float acc = 0.0f;
  for (int ti = threadIdx.y; ti < kTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (gi >= S || gj >= S) continue;
      const int k = (ti + halo) * w + tj + halo;
      u_out[(size_t)gi * S + gj] = v[k];
      if (partials != nullptr && is_interior(gi, gj, n)) {
        const float rr = residual_at(v, bw, k, w);
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

// ---------------------------------------------------------------------------
// Standalone transfers: one thread per output node, no shared memory.
// ---------------------------------------------------------------------------

// FW restriction at coarse node (I, J): blur the fine rows 2I-1..2I+1 along
// the row, then blur those three across, as ops.restrict_fw does.  Nodes
// outside the coarse interior 1..nc-1 (the tail past S/2 among them) get 0.
__global__ void __launch_bounds__(kThreads)
restrict_fw_kernel(const float* __restrict__ r, float* __restrict__ rc,
                   int S, int Sc, int nc) {
  const int I = blockIdx.y * blockDim.y + threadIdx.y;
  const int J = blockIdx.x * blockDim.x + threadIdx.x;
  if (I >= Sc || J >= Sc) return;
  float val = 0.0f;
  if (I >= 1 && I <= nc - 1 && J >= 1 && J <= nc - 1) {
    const float* row = r + (size_t)(2 * I) * S;
    const int j = 2 * J;
    val = row_blur(row, j) + 0.5f * (row_blur(row - S, j) +
                                     row_blur(row + S, j));
  }
  rc[(size_t)I * Sc + J] = val;
}

// out = mask(u + P ec): K2's correction without the smoothing steps.
__global__ void __launch_bounds__(kThreads)
prolong_add_kernel(const float* __restrict__ u, const float* __restrict__ ec,
                   float* __restrict__ out, int S, int Sc, int n) {
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S || j >= S) return;
  const size_t k = (size_t)i * S + j;
  const int m = min(Sc, (S + 1) / 2);
  out[k] = is_interior(i, j, n) ? u[k] + prolong_at(ec, Sc, m, i, j) : 0.0f;
}

// (hi, err) with hi + err == (P ec)[i, j] exactly.  The weights 1, 1/2, 1/4
// are exponent shifts, so only the neighbour sums round, and TwoSum keeps
// their error.  The order is the TPU kernel's (transfer.py::
// _bilinear_prolong_comp): the odd-odd node pairs each column first,
// (c + c_down) and (c_right + c_down_right), and its error is
// t1 + (t2 + t3).
__global__ void __launch_bounds__(kThreads)
prolong_comp_kernel(const float* __restrict__ ec, float* __restrict__ hi,
                    float* __restrict__ err, int S, int Sc, int n) {
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S || j >= S) return;
  const size_t k = (size_t)i * S + j;
  float h = 0.0f;
  float e = 0.0f;
  if (is_interior(i, j, n)) {
    const int m = min(Sc, (S + 1) / 2);
    const int I = i >> 1;
    const int J = j >> 1;
    auto c = [&](int a, int bb) {
      return (a < m && bb < m) ? __ldg(ec + (size_t)a * Sc + bb) : 0.0f;
    };
    const bool odd_i = i & 1;
    const bool odd_j = j & 1;
    float s, t;
    if (!odd_i && !odd_j) {
      h = c(I, J);
    } else if (odd_i && !odd_j) {
      two_sum(c(I, J), c(I + 1, J), s, t);
      h = __fmul_rn(0.5f, s);
      e = __fmul_rn(0.5f, t);
    } else if (!odd_i && odd_j) {
      two_sum(c(I, J), c(I, J + 1), s, t);
      h = __fmul_rn(0.5f, s);
      e = __fmul_rn(0.5f, t);
    } else {
      float s1, t1, s2, t2, t3;
      two_sum(c(I, J), c(I + 1, J), s1, t1);
      two_sum(c(I, J + 1), c(I + 1, J + 1), s2, t2);
      two_sum(s1, s2, s, t3);
      h = __fmul_rn(0.25f, s);
      e = __fmul_rn(0.25f, __fadd_rn(t1, __fadd_rn(t2, t3)));
    }
  }
  hi[k] = h;
  err[k] = e;
}

dim3 node_grid(int S) {
  return dim3((S + kThreadsX - 1) / kThreadsX, (S + kThreadsY - 1) / kThreadsY);
}

}  // namespace

extern "C" {

int tmt_transfer_tile(void) { return kTile; }

// Largest `steps` whose window fits in shared memory (K1's halo is deeper).
int tmt_transfer_max_steps(void) {
  int steps = 0;
  while (window_bytes(steps + 3) <= kMaxSmemBytes) ++steps;
  return steps;
}

const char* tmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// weights: host array [c1[0..count), c2[0..count)], ignored for RB-GS.
// Grid covers 2*Sc (>= S) so that the coarse tail past S/2 is zeroed too.
int tmt_smooth_restrict(const void* u, const void* b, void* u_out, void* rc,
                        int S, int Sc, int n, int steps, int rbgs,
                        const void* weights, int count, void* stream) {
  static int configured[kMaxDevices] = {};
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const int bytes = window_bytes(steps + 2);
  err = allow_smem(smooth_restrict_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (2 * Sc + kTile - 1) / kTile;
  smooth_restrict_kernel<<<dim3(tiles, tiles), dim3(kThreadsX, kThreadsY),
                           bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<float*>(u_out), static_cast<float*>(rc), S, Sc, n, steps,
      rbgs, wt);
  return cudaGetLastError();
}

// partials: (S/kTile rounded up)^2 floats, or null for no resnorm; then
// out_sum[0] receives the sum of (b - A u')^2 over the interior.
int tmt_prolong_smooth(const void* u, const void* b, const void* ec,
                       void* u_out, void* partials, void* out_sum, int S,
                       int Sc, int n, int steps, int rbgs,
                       const void* weights, int count, void* stream) {
  static int configured[kMaxDevices] = {};
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const int bytes = window_bytes(steps + 1);
  err = allow_smem(prolong_smooth_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTile - 1) / kTile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  prolong_smooth_kernel<<<dim3(tiles, tiles), dim3(kThreadsX, kThreadsY),
                          bytes, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<const float*>(ec), static_cast<float*>(u_out),
      static_cast<float*>(partials), S, Sc, n, steps, rbgs, wt);
  err = cudaGetLastError();
  if (err != cudaSuccess || partials == nullptr) return err;
  sum_partials_kernel<<<1, dim3(kThreadsX, kThreadsY), 0, st>>>(
      static_cast<const float*>(partials), tiles * tiles,
      static_cast<float*>(out_sum));
  return cudaGetLastError();
}

// rc (Sc x Sc) = FW(r), zero outside the coarse interior 1..n/2-1.
int tmt_restrict_fw(const void* r, void* rc, int S, int Sc, int n,
                    void* stream) {
  restrict_fw_kernel<<<node_grid(Sc), dim3(kThreadsX, kThreadsY), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<float*>(rc), S, Sc, n / 2);
  return cudaGetLastError();
}

// out (S x S) = mask(u + P ec).
int tmt_prolong_add(const void* u, const void* ec, void* out, int S, int Sc,
                    int n, void* stream) {
  prolong_add_kernel<<<node_grid(S), dim3(kThreadsX, kThreadsY), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(ec),
      static_cast<float*>(out), S, Sc, n);
  return cudaGetLastError();
}

// hi, err (S x S) with hi + err == mask(P ec) exactly.
int tmt_prolong_comp(const void* ec, void* hi, void* err, int S, int Sc,
                     int n, void* stream) {
  prolong_comp_kernel<<<node_grid(S), dim3(kThreadsX, kThreadsY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ec), static_cast<float*>(hi),
      static_cast<float*>(err), S, Sc, n);
  return cudaGetLastError();
}

}  // extern "C"
