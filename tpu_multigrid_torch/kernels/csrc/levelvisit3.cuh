// The two kernels of a 3D level visit on the window of window3.cuh, generic
// in the operator `Op` (window3.cuh's ConstOp3 for K1_3/K2_3 in
// transfer3d.cu, vartransfer3d.cu's VarOp3 for K1v_3/K2v_3):
//
//   K1: `steps` smoothing steps, the residual r = b - A u', and the full-
//       weighting restriction R = P^T / 2 of r, masked to the coarse
//       interior; coarse nodes past S/2 along any axis are zero.  Writes u'
//       and rc.
//   K2: u <- mask(u + P ec) with trilinear P, then `steps` smoothing steps;
//       optionally one partial sum of (b - A u')^2 per block.  With ec null
//       it is a smoothing pass alone: u is loaded as it is (a continuation
//       of a smoothing that an earlier launch began).
//
// A block owns one fine tile.  Its window holds the tile with a halo of
// steps + 2 layers for K1 (each step invalidates one layer, the residual
// and the blur need two more) and steps + 1 for K2 with the resnorm (steps
// without it).  The tile sides are even, so a tile's coarse nodes are the
// even nodes of the tile and the restriction reads the residual from shared
// memory.  K2 evaluates P ec at every window cell straight from device
// memory (the eighth-size ec is served mostly from L1/L2).  `first_step` is
// the global index of the launch's first step, so that a smoothing split
// over several launches carries its Jacobi weights (rotated by the host)
// and its RB-GS colours on.
//
// Arithmetic: the Pallas kernels' order, as the plain versions repeat it:
// the restriction blurs x, then y, then z and halves; the prolongation
// averages x, then y, then z.  The resnorm partials are summed in a fixed
// tree order with no atomics, so the norm repeats run to run.

#pragma once

#include "levelvisit.cuh"
#include "window3.cuh"

namespace {

// Trilinear prolongation of ec at fine node (i, j, k) >= 0, averaging x,
// then y, then z; coarse nodes at or past m read 0.  An even index takes the
// coarse value itself, which is what the Pallas kernel's 0.5 (c + c) gives.
__device__ __forceinline__ float prolong3_at(const float* __restrict__ ec,
                                             const Grid3& gc, int mz, int my,
                                             int mx, int i, int j, int k) {
  const int I = i >> 1;
  const int J = j >> 1;
  const int K = k >> 1;
  auto c = [&](int a, int bb, int cc) {
    return (a < mz && bb < my && cc < mx) ? __ldg(ec + gidx(gc, a, bb, cc))
                                          : 0.0f;
  };
  auto px = [&](int a, int bb) {
    return (k & 1) ? 0.5f * (c(a, bb, K) + c(a, bb, K + 1)) : c(a, bb, K);
  };
  auto py = [&](int a) {
    return (j & 1) ? 0.5f * (px(a, J) + px(a, J + 1)) : px(a, J);
  };
  return (i & 1) ? 0.5f * (py(I) + py(I + 1)) : py(I);
}

template <typename Op>
__global__ void __launch_bounds__(kThreads3)
smooth_restrict3_kernel(const float* __restrict__ u,
                        const float* __restrict__ b,
                        float* __restrict__ u_out, float* __restrict__ rc,
                        Grid3 g, Grid3 gc, int steps, int first_step,
                        int rbgs, Weights wt, Op op) {
  extern __shared__ float smem[];
  const int halo = steps + 2;
  const int tyz = kW3yz - 2 * halo;   // even: the coarse tile is tyz / 2
  const int tx = kW3x - 2 * halo;
  const int zo = blockIdx.z * tyz;
  const int yo = blockIdx.y * tyz;
  const int xo = blockIdx.x * tx;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int cyz = tyz / 2;
  const int cx = tx / 2;
  const int ncoarse = cyz * cyz * cx;

  if (zo >= g.Sz || yo >= g.Sy || xo >= g.Sx) {
    // Coarse tail past S/2: no fine node maps here; it stays zero.
    for (int i = tid; i < ncoarse; i += kThreads3) {
      const int K = xo / 2 + i % cx;
      const int J = yo / 2 + (i / cx) % cyz;
      const int I = zo / 2 + i / (cx * cyz);
      if (I < gc.Sz && J < gc.Sy && K < gc.Sx) rc[gidx(gc, I, J, K)] = 0.0f;
    }
    return;
  }

  const int z0 = zo - halo;
  const int y0 = yo - halo;
  const int x0 = xo - halo;
  float* buf_a = smem;
  float* buf_b = smem + kW3Cells;
  float* bw = smem + 2 * kW3Cells;
  load_window3(buf_a, u, g, z0, y0, x0);
  load_window3(bw, b, g, z0, y0, x0);
  __syncthreads();

  const float* v = smooth3(buf_a, buf_b, bw, z0, y0, x0, g.n, steps,
                           first_step, rbgs, wt, op);
  float* r = (v == buf_a) ? buf_b : buf_a;

  // u' on the tile, and the residual on the tile plus one layer (what the
  // restriction reads).
  const int lx = threadIdx.x;
  const int gx = x0 + lx;
  const bool x_tile = lx >= halo && lx < halo + tx;
  const bool x_ring = lx >= halo - 1 && lx <= halo + tx;
  for (int row = threadIdx.y; row < kW3Rows; row += blockDim.y) {
    int lz, ly;
    row_coords(row, lz, ly);
    if (lz < halo - 1 || lz > halo + tyz || ly < halo - 1 ||
        ly > halo + tyz || !x_ring) {
      continue;
    }
    const int gz = z0 + lz;
    const int gy = y0 + ly;
    const int k = row * kW3x + lx;
    r[k] = interior3(gz, gy, gx, g.n) ? op.residual(v, bw, k, gz, gy, gx)
                                      : 0.0f;
    if (x_tile && lz >= halo && lz < halo + tyz && ly >= halo &&
        ly < halo + tyz && in_array3(g, gz, gy, gx)) {
      u_out[gidx(g, gz, gy, gx)] = v[k];
    }
  }
  __syncthreads();

  // R = P^T / 2 at the tile's even nodes: blur x, then y, then z, halve.
  const int nc = g.n / 2;
  for (int i = tid; i < ncoarse; i += kThreads3) {
    const int ck = i % cx;
    const int cj = (i / cx) % cyz;
    const int ci = i / (cx * cyz);
    const int I = zo / 2 + ci;
    const int J = yo / 2 + cj;
    const int K = xo / 2 + ck;
    if (I >= gc.Sz || J >= gc.Sy || K >= gc.Sx) continue;
    float val = 0.0f;
    if (interior3(I, J, K, nc)) {
      const int k = (2 * ci + halo) * kW3Plane + (2 * cj + halo) * kW3x +
                    2 * ck + halo;
      auto t1 = [&](int q) { return r[q] + 0.5f * (r[q - 1] + r[q + 1]); };
      auto t2 = [&](int q) {
        return t1(q) + 0.5f * (t1(q - kW3x) + t1(q + kW3x));
      };
      val = 0.5f * (t2(k) + 0.5f * (t2(k - kW3Plane) + t2(k + kW3Plane)));
    }
    rc[gidx(gc, I, J, K)] = val;
  }
}

template <typename Op>
__global__ void __launch_bounds__(kThreads3)
prolong_smooth3_kernel(const float* __restrict__ u,
                       const float* __restrict__ b,
                       const float* __restrict__ ec,
                       float* __restrict__ u_out,
                       float* __restrict__ partials, Grid3 g, Grid3 gc,
                       int steps, int first_step, int rbgs, Weights wt,
                       Op op) {
  extern __shared__ float smem[];
  const int halo = steps + (partials != nullptr ? 1 : 0);
  const int tyz = kW3yz - 2 * halo;
  const int tx = kW3x - 2 * halo;
  const int z0 = blockIdx.z * tyz - halo;
  const int y0 = blockIdx.y * tyz - halo;
  const int x0 = blockIdx.x * tx - halo;
  const int mz = min(gc.Sz, (g.Sz + 1) / 2);
  const int my = min(gc.Sy, (g.Sy + 1) / 2);
  const int mx = min(gc.Sx, (g.Sx + 1) / 2);
  float* buf_a = smem;
  float* buf_b = smem + kW3Cells;
  float* bw = smem + 2 * kW3Cells;

  const int lx = threadIdx.x;
  const int gx = x0 + lx;
  if (ec == nullptr) {
    load_window3(buf_a, u, g, z0, y0, x0);
  } else {
    for (int row = threadIdx.y; row < kW3Rows; row += blockDim.y) {
      int lz, ly;
      row_coords(row, lz, ly);
      const int gz = z0 + lz;
      const int gy = y0 + ly;
      buf_a[row * kW3x + lx] =
          interior3(gz, gy, gx, g.n)
              ? u[gidx(g, gz, gy, gx)] +
                    prolong3_at(ec, gc, mz, my, mx, gz, gy, gx)
              : 0.0f;
    }
  }
  load_window3(bw, b, g, z0, y0, x0);
  __syncthreads();

  const float* v = smooth3(buf_a, buf_b, bw, z0, y0, x0, g.n, steps,
                           first_step, rbgs, wt, op);

  float acc = 0.0f;
  const bool x_tile = lx >= halo && lx < halo + tx;
  for (int row = threadIdx.y; row < kW3Rows; row += blockDim.y) {
    int lz, ly;
    row_coords(row, lz, ly);
    if (!x_tile || lz < halo || lz >= halo + tyz || ly < halo ||
        ly >= halo + tyz) {
      continue;
    }
    const int gz = z0 + lz;
    const int gy = y0 + ly;
    if (!in_array3(g, gz, gy, gx)) continue;
    const int k = row * kW3x + lx;
    u_out[gidx(g, gz, gy, gx)] = v[k];
    if (partials != nullptr && interior3(gz, gy, gx, g.n)) {
      const float rr = op.residual(v, bw, k, gz, gy, gx);
      acc += rr * rr;
    }
  }
  if (partials != nullptr) {
    float* red = (v == buf_a) ? buf_b : buf_a;
    const float total = block_sum3(acc, red);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      partials[(static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                   gridDim.x +
               blockIdx.x] = total;
    }
  }
}

// One K1 launch of `steps` steps starting at global step `first_step`.  The
// grid covers 2 * Sc along each axis (>= S) so that the coarse tail past S/2
// is zeroed too.
template <typename Op>
cudaError_t launch_smooth_restrict3(const float* u, const float* b,
                                    float* u_out, float* rc, const Grid3& g,
                                    const Grid3& gc, int steps,
                                    int first_step, int rbgs,
                                    const Weights& wt, const Op& op,
                                    cudaStream_t st) {
  static int configured[kMaxDevices] = {};
  const int halo = steps + 2;
  if (steps < 0 || first_step < 0 || halo > kMaxHalo3) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(smooth_restrict3_kernel<Op>, kWindow3Bytes,
                               configured);
  if (err != cudaSuccess) return err;
  const int tyz = kW3yz - 2 * halo;
  const dim3 grid(tiles(2 * gc.Sx, kW3x - 2 * halo), tiles(2 * gc.Sy, tyz),
                  tiles(2 * gc.Sz, tyz));
  smooth_restrict3_kernel<Op><<<grid, dim3(kW3x, kThreads3Y), kWindow3Bytes,
                                st>>>(u, b, u_out, rc, g, gc, steps,
                                      first_step, rbgs, wt, op);
  return cudaGetLastError();
}

// The number of blocks, and so of resnorm partials, of one K2 launch of
// `steps` steps with the resnorm.
inline int prolong_smooth3_blocks(int Sz, int Sy, int Sx, int steps) {
  const int halo = steps + 1;
  const int tyz = kW3yz - 2 * halo;
  return tiles(Sx, kW3x - 2 * halo) * tiles(Sy, tyz) * tiles(Sz, tyz);
}

// One K2 launch; ec may be null (a smoothing pass alone), partials null
// (no resnorm); with partials, out_sum[0] receives the sum of (b - A u')^2
// over the interior.
template <typename Op>
cudaError_t launch_prolong_smooth3(const float* u, const float* b,
                                   const float* ec, float* u_out,
                                   float* partials, float* out_sum,
                                   const Grid3& g, const Grid3& gc, int steps,
                                   int first_step, int rbgs,
                                   const Weights& wt, const Op& op,
                                   cudaStream_t st) {
  static int configured[kMaxDevices] = {};
  const int halo = steps + (partials != nullptr ? 1 : 0);
  if (steps < 0 || first_step < 0 || halo > kMaxHalo3) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(prolong_smooth3_kernel<Op>, kWindow3Bytes,
                               configured);
  if (err != cudaSuccess) return err;
  const int tyz = kW3yz - 2 * halo;
  const dim3 grid(tiles(g.Sx, kW3x - 2 * halo), tiles(g.Sy, tyz),
                  tiles(g.Sz, tyz));
  prolong_smooth3_kernel<Op><<<grid, dim3(kW3x, kThreads3Y), kWindow3Bytes,
                               st>>>(u, b, ec, u_out, partials, g, gc, steps,
                                     first_step, rbgs, wt, op);
  err = cudaGetLastError();
  if (err != cudaSuccess || partials == nullptr) return err;
  sum_partials_kernel<<<1, dim3(kThreadsX, kThreadsY), 0, st>>>(
      partials, static_cast<int>(grid.x * grid.y * grid.z), out_sum);
  return cudaGetLastError();
}

}  // namespace
