// K1-local (smooth_restrict_ext) and K2-local (prolong_smooth_ext, with or
// without the owned resnorm): the two kernels of a level visit on a
// ghost-extended block, and K0-local (smooth_ext, residual_ext): the
// streaming smoother on such a block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/local.py::_k1_local,
// ::_k2_local and ::_streamed_local.
//
// The block is an (R, C) = (lr + 2*GR, lc + 2*GC) array, GR = 16 ghost rows
// and GC = 256 ghost columns a side, whose cell (i, j) has the global
// coordinates (o0 + i, o1 + j); the masks and the RB-GS colours are those of
// the global coordinates (ExtGeom, window.cuh), so one launch serves a shard
// at any position of a decomposed grid, and the periodic fused tier
// (cycles/periodic_fused.py) passes origin (2, 2) and a virtual n so large
// that every cell is a live unknown.  The coarse block is (R/2 + GR,
// C/2 + GC): fine cell (i, j), both even, restricts to coarse cell
// (i/2 + GR/2, j/2 + GC/2), and fine cell (i, j) prolongs from the coarse
// cells around (i/2 + GR/2, j/2 + GC/2).
//
//   K1: `steps` Jacobi (per-step weights) or red-black Gauss-Seidel steps
//       on u, then r = b - A u, then the full-weighting aggregate of r at
//       the even cells, masked to the coarse interior (global coordinates
//       (o0 + i)/2, (o1 + j)/2 floored, in 1..n/2-1).  Writes u' (R, C) and
//       the coarse block, zero outside the rows and columns the fine block
//       restricts to.
//   K2: u <- where(live, u + P ec, 0), then `steps` smoothing steps.  Writes
//       u'; the resnorm variant also writes one partial sum of (b - A u')^2
//       over the owned live cells (rows GR..R-GR-1, columns GC..C-GC-1) per
//       block, which a one-block kernel adds up in a fixed order.
//   K0: `steps` smoothing steps on u (u' written), or, with no steps, the
//       residual r = b - A u at the live cells and 0 elsewhere (r written).
//       The distributed refinement (dist/refine_pallas.py) smooths its
//       delta-form corrections with it.
//
// Every output is defined on the whole array: cells outside the array read
// as zero and are never updated, as in the plain versions, so the kernels
// match them bitwise everywhere, ghosts included.  (The TPU kernels wrap
// their windows around and leave the ghost ring undefined; the two agree on
// the owned region, which is all a caller reads after refreshing ghosts.)
//
// What bounds them: device-memory traffic, as for K1/K2 (transfer.cu): u
// and b read and u' written, plus the quarter-size coarse block, about 3.3
// passes of R*C*4 bytes, against 8*steps + 16 flops per cell.
//
// What the design does about it: transfer.cu's.  One block per 64x64 fine
// tile at an even array origin loads the tile plus a halo of steps + 2 rings
// (K1), steps + 1 (K2) or steps, one more with the residual (K0), into
// shared memory, runs every step there and writes only the outputs.  K0 is
// the streaming smoother in window.cuh's form on this geometry: 2 or 3
// passes of R*C*4 bytes against 8*steps (or 6) flops per cell.
//
// Arithmetic: the TPU kernels' operations in their order (kernels/
// local.py, transfer.py::_fw_aggregate and ::_bilinear_prolong), built with
// -fmad=false: the aggregate is 0.25 * ((row3[j-1] + 2 row3[j]) + row3[j+1])
// with row3 = (r[i-1] + 2 r[i]) + r[i+1], and the odd-odd prolongation is
// 0.5 * (0.5 * (c + c_down) + 0.5 * (c_right + c_down_right)).

#include "extvisit.cuh"
#include "levelvisit.cuh"
#include "window.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
smooth_restrict_ext_kernel(const float* __restrict__ u,
                           const float* __restrict__ b,
                           float* __restrict__ u_out, float* __restrict__ rc,
                           ExtGeom g, int steps, int rbgs, Weights wt) {
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

  float* v = smooth_window(buf_a, buf_b, bw, w, r0, c0, g, steps, 0, rbgs,
                           wt);
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

  // Residual on the tile plus one ring: what the restriction reads.
  for (int li = halo - 1 + threadIdx.y; li <= halo + kTile; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = halo - 1 + threadIdx.x; lj <= halo + kTile;
         lj += blockDim.x) {
      const int gj = c0 + lj;
      const int k = li * w + lj;
      r[k] = g.live(gi, gj) ? residual_at(v, bw, k, w) : 0.0f;
    }
  }
  __syncthreads();

  // The aggregate at the tile's even cells, into the coarse block.
  const int ct = kTile / 2;
  for (int ci = threadIdx.y; ci < ct; ci += blockDim.y) {
    const int gi = ro + 2 * ci;
    for (int cj = threadIdx.x; cj < ct; cj += blockDim.x) {
      const int gj = co + 2 * cj;
      if (!g.in_array(gi, gj)) continue;
      const int hi = gi / 2 + fo0;
      const int hj = gj / 2 + fo1;
      float val = 0.0f;
      if (is_interior(hi, hj, nc)) {
        val = fw_aggregate(r, (2 * ci + halo) * w + 2 * cj + halo, w);
      }
      rc[(size_t)(gi / 2 + kGR / 2) * Cc + gj / 2 + kGC / 2] = val;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
prolong_smooth_ext_kernel(const float* __restrict__ u,
                          const float* __restrict__ b,
                          const float* __restrict__ ec,
                          float* __restrict__ u_out,
                          float* __restrict__ partials, ExtGeom g, int steps,
                          int rbgs, Weights wt) {
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

  float* v = smooth_window(buf_a, buf_b, bw, w, r0, c0, g, steps, 0, rbgs,
                           wt);

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

// K0-local: `steps` smoothing steps (u_out) or, with steps == 0 and r_out,
// the residual of u (r_out).
__global__ void __launch_bounds__(kThreads)
streamed_ext_kernel(const float* __restrict__ u, const float* __restrict__ b,
                    float* __restrict__ u_out, float* __restrict__ r_out,
                    ExtGeom g, int steps, int rbgs, Weights wt) {
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
  load_window(buf_a, u, g, r0, c0, w);
  load_window(bw, b, g, r0, c0, w);
  __syncthreads();

  const float* v = smooth_window(buf_a, buf_b, bw, w, r0, c0, g, steps, 0,
                                 rbgs, wt);

  for (int ti = threadIdx.y; ti < kTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (!g.in_array(gi, gj)) continue;
      const int k = (ti + halo) * w + tj + halo;
      if (u_out != nullptr) u_out[g.at(gi, gj)] = v[k];
      if (r_out != nullptr) {
        r_out[g.at(gi, gj)] = g.live(gi, gj) ? residual_at(v, bw, k, w)
                                             : 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// u, b, u_out: (R, C); rc: (R/2 + GR, C/2 + GC).  weights: host array
// [c1[0..count), c2[0..count)], ignored for RB-GS.
int tmt_smooth_restrict_ext(const void* u, const void* b, void* u_out,
                            void* rc, int R, int C, int o0, int o1, int n,
                            int steps, int rbgs, const void* weights,
                            int count, void* stream) {
  static int configured[kMaxDevices] = {};
  if (R % 2 || C % 2) return cudaErrorInvalidValue;
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const int bytes = window_bytes(steps + 2);
  err = allow_smem(smooth_restrict_ext_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ExtGeom g{R, C, o0, o1, n};
  smooth_restrict_ext_kernel<<<tile_grid(R, C), dim3(kThreadsX, kThreadsY),
                               bytes, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<float*>(u_out), static_cast<float*>(rc), g, steps, rbgs,
      wt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return zero_frame(static_cast<float*>(rc), R, C, st);
}

// ec: (R/2 + GR, C/2 + GC).  partials: one float per 64x64 tile of (R, C),
// or null for no resnorm; then out_sum[0] receives the sum of (b - A u')^2
// over the owned live cells.
int tmt_prolong_smooth_ext(const void* u, const void* b, const void* ec,
                           void* u_out, void* partials, void* out_sum, int R,
                           int C, int o0, int o1, int n, int steps, int rbgs,
                           const void* weights, int count, void* stream) {
  static int configured[kMaxDevices] = {};
  if (R % 2 || C % 2) return cudaErrorInvalidValue;
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const int bytes = window_bytes(steps + 1);
  err = allow_smem(prolong_smooth_ext_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = tile_grid(R, C);
  const ExtGeom g{R, C, o0, o1, n};
  prolong_smooth_ext_kernel<<<grid, dim3(kThreadsX, kThreadsY), bytes, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<const float*>(ec), static_cast<float*>(u_out),
      static_cast<float*>(partials), g, steps, rbgs, wt);
  err = cudaGetLastError();
  if (err != cudaSuccess || partials == nullptr) return err;
  sum_partials_kernel<<<1, dim3(kThreadsX, kThreadsY), 0, st>>>(
      static_cast<const float*>(partials), grid.x * grid.y,
      static_cast<float*>(out_sum));
  return cudaGetLastError();
}

// K0-local.  u_out or r_out may be null (not written); r_out only with
// steps == 0.  weights as above.
int tmt_streamed_ext(const void* u, const void* b, void* u_out, void* r_out,
                     int R, int C, int o0, int o1, int n, int steps, int rbgs,
                     const void* weights, int count, void* stream) {
  static int configured[kMaxDevices] = {};
  if (steps < 0 || (r_out != nullptr && steps != 0)) {
    return cudaErrorInvalidValue;
  }
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const int bytes = window_bytes(steps + (r_out != nullptr ? 1 : 0));
  err = allow_smem(streamed_ext_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  const ExtGeom g{R, C, o0, o1, n};
  streamed_ext_kernel<<<tile_grid(R, C), dim3(kThreadsX, kThreadsY), bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<float*>(u_out), static_cast<float*>(r_out), g, steps, rbgs,
      wt);
  return cudaGetLastError();
}

}  // extern "C"
