// The two kernels of a 3D level visit on the window of window3.cuh, generic
// in the operator `Op` (window3.cuh's ConstOp3 for K2_3 and the static-taps
// K1_3 in transfer3d.cu, fas3d.cu's FAS operators for K1f_3/K2f_3,
// vartransfer3d.cu's VarOp3 for K2v_3; K1v_3 and the 7-point K1_3 run on
// zmarch3.cuh's z march instead):
//
//   K1: `steps` smoothing steps, the residual r = b - A u', and the full-
//       weighting restriction R = P^T / 2 of r, masked to the coarse
//       interior; coarse nodes past S/2 along any axis are zero.  Writes u'
//       and rc.  Its FAS variant (Fas = true, fas3d.cu) writes in rc's place
//       the FAS coarse right-hand side bc = N_c(uc0) + R r, and also the
//       solution injection uc0 = u'[2I, 2J, 2K]: the operator's
//       coarse_apply evaluates N_c on u' at the even nodes, whose coarse
//       neighbours lie two fine layers out, inside K1's halo.
//   K2: u <- mask(u + P ec) with trilinear P, then `steps` smoothing steps;
//       optionally one partial sum of (b - A u')^2 per block.  With ec null
//       it is a smoothing pass alone: u is loaded as it is (a continuation
//       of a smoothing that an earlier launch began).
//
// Both run on a whole padded level or on a ghost-extended block (Grid3's
// origin and ghost widths, the distributed tier): the masks and colours
// come from global indices, and cells outside the array read as zero.  On
// a block, K1 writes the coarse block whole: the coarse cells no fine cell
// of the array restricts to (its frame) are zero, and the coarse interior
// mask is taken in global coarse coordinates; K2 reads ec at the coarse
// block's placement and its resnorm sums the owned cells only.
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

// Trilinear prolongation of ec at fine array node (i, j, k) >= 0 of `g`,
// averaging x, then y, then z; the fine node's coarse neighbours sit at
// (i / 2 + hz / 2, j / 2 + hy / 2, k / 2) of ec, and those past ec's extent
// read 0.  An even index takes the coarse value itself, which is what the
// Pallas kernel's 0.5 (c + c) gives.
__device__ __forceinline__ float prolong3_at(const float* __restrict__ ec,
                                             const Grid3& g, const Grid3& gc,
                                             int i, int j, int k) {
  const int I = (i >> 1) + g.hz / 2;
  const int J = (j >> 1) + g.hy / 2;
  const int K = k >> 1;
  auto c = [&](int a, int bb, int cc) {
    return (a < gc.Sz && bb < gc.Sy && cc < gc.Sx)
               ? __ldg(ec + gidx(gc, a, bb, cc))
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

template <typename Op, bool Fas>
__global__ void __launch_bounds__(kThreads3)
smooth_restrict3_kernel(const float* __restrict__ u,
                        const float* __restrict__ b,
                        float* __restrict__ u_out, float* __restrict__ rc,
                        float* __restrict__ uc, Grid3 g, Grid3 gc, int steps,
                        int first_step, int rbgs, Weights wt, Op op) {
  extern __shared__ float smem[];
  const int halo = steps + 2;
  const int tyz = kW3yz - 2 * halo;   // even: the coarse tile is tyz / 2
  const int tx = kW3x - 2 * halo;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int cyz = tyz / 2;
  const int cx = tx / 2;
  const int ncoarse = cyz * cyz * cx;
  // The blocks tile the coarse array; the fine tile of coarse tile
  // (Iz, Jy, Kx) starts at fine (2 Iz - hz, 2 Jy - hy, 2 Kx), which lies
  // outside a ghost-extended block for the coarse frame.
  const int Iz = blockIdx.z * cyz;
  const int Jy = blockIdx.y * cyz;
  const int Kx = blockIdx.x * cx;
  const int zo = 2 * Iz - g.hz;
  const int yo = 2 * Jy - g.hy;
  const int xo = 2 * Kx;

  if (zo >= g.Sz || yo >= g.Sy || xo >= g.Sx || zo + tyz <= 0 ||
      yo + tyz <= 0) {
    // No fine node of the array in the tile (the coarse tail past S/2, or a
    // block's coarse frame): its coarse nodes are zero.
    for (int i = tid; i < ncoarse; i += kThreads3) {
      const int K = Kx + i % cx;
      const int J = Jy + (i / cx) % cyz;
      const int I = Iz + i / (cx * cyz);
      if (I < gc.Sz && J < gc.Sy && K < gc.Sx) {
        rc[gidx(gc, I, J, K)] = 0.0f;
        if constexpr (Fas) uc[gidx(gc, I, J, K)] = 0.0f;
      }
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

  const float* v = smooth3(buf_a, buf_b, bw, g, z0, y0, x0, steps,
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
    r[k] = live3(g, gz, gy, gx) ? op.residual(v, bw, k, gz, gy, gx) : 0.0f;
    if (x_tile && lz >= halo && lz < halo + tyz && ly >= halo &&
        ly < halo + tyz && in_array3(g, gz, gy, gx)) {
      u_out[gidx(g, gz, gy, gx)] = v[k];
    }
  }
  __syncthreads();

  // R = P^T / 2 at the tile's even nodes: blur x, then y, then z, halve;
  // the coarse mask in global coarse coordinates (gc's origin).  A coarse
  // node whose fine node lies outside the array is zero.
  const int nc = g.n / 2;
  for (int i = tid; i < ncoarse; i += kThreads3) {
    const int ck = i % cx;
    const int cj = (i / cx) % cyz;
    const int ci = i / (cx * cyz);
    const int I = Iz + ci;
    const int J = Jy + cj;
    const int K = Kx + ck;
    if (I >= gc.Sz || J >= gc.Sy || K >= gc.Sx) continue;
    float val = 0.0f;
    float u0 = 0.0f;
    if (in_array3(g, zo + 2 * ci, yo + 2 * cj, xo + 2 * ck) &&
        interior3(I + gc.oz, J + gc.oy, K, nc)) {
      const int k = (2 * ci + halo) * kW3Plane + (2 * cj + halo) * kW3x +
                    2 * ck + halo;
      auto t1 = [&](int q) { return r[q] + 0.5f * (r[q - 1] + r[q + 1]); };
      auto t2 = [&](int q) {
        return t1(q) + 0.5f * (t1(q - kW3x) + t1(q + kW3x));
      };
      val = 0.5f * (t2(k) + 0.5f * (t2(k - kW3Plane) + t2(k + kW3Plane)));
      if constexpr (Fas) {
        // uc0 at coarse (I + dz, J + dy, K + dx): u' two fine layers out
        // along each offset axis, 0 outside the coarse interior.
        auto c = [&](int dz, int dy, int dx) {
          return interior3(I + gc.oz + dz, J + gc.oy + dy, K + dx, nc)
                     ? v[k + 2 * (dz * kW3Plane + dy * kW3x + dx)]
                     : 0.0f;
        };
        u0 = v[k];
        val = op.coarse_apply(u0, c) + val;
      }
    }
    rc[gidx(gc, I, J, K)] = val;
    if constexpr (Fas) uc[gidx(gc, I, J, K)] = u0;
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
          live3(g, gz, gy, gx)
              ? u[gidx(g, gz, gy, gx)] + prolong3_at(ec, g, gc, gz, gy, gx)
              : 0.0f;
    }
  }
  load_window3(bw, b, g, z0, y0, x0);
  __syncthreads();

  const float* v = smooth3(buf_a, buf_b, bw, g, z0, y0, x0, steps,
                           first_step, rbgs, wt, op);

  // The resnorm sums the owned live cells: the whole array's live cells on
  // a padded level, the ones inside the ghost zones on a block.
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
    if (partials != nullptr && live3(g, gz, gy, gx) && gz >= g.hz &&
        gz < g.Sz - g.hz && gy >= g.hy && gy < g.Sy - g.hy) {
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

// The fine and coarse grids of a ghost-extended (Rz, Ry, Sx) block whose
// cell (0, 0, 0) sits at global (oz, oy, 0), with hz ghost planes and hy
// ghost rows a side, and of its (Rz / 2 + hz, Ry / 2 + hy, Scx) coarse
// block.  The origin and the ghost widths must be even (so that the
// restriction's decimation and P's parities stay local ones); the coarse
// block's origin is then (oz / 2 - hz / 2, oy / 2 - hy / 2).
inline cudaError_t ext_grids3(int Rz, int Ry, int Sx, int Scx, int n, int oz,
                              int oy, int hz, int hy, Grid3* g, Grid3* gc) {
  if ((oz | oy | hz | hy | Rz | Ry) & 1 || hz < 0 || hy < 0 ||
      Rz <= 2 * hz || Ry <= 2 * hy) {
    return cudaErrorInvalidValue;
  }
  *g = Grid3{Rz, Ry, Sx, n, oz, oy, hz, hy};
  *gc = Grid3{Rz / 2 + hz, Ry / 2 + hy, Scx, n / 2, oz / 2 - hz / 2,
              oy / 2 - hy / 2};
  return cudaSuccess;
}

// One K1 launch of `steps` steps starting at global step `first_step`.  The
// grid covers the coarse array (2 * Sc fine nodes along each axis, >= S) so
// that the coarse tail past S/2, or a block's coarse frame, is zeroed too.
// Fas = true: the FAS variant, writing bc into rc and uc0 into uc.
template <typename Op, bool Fas = false>
cudaError_t launch_smooth_restrict3(const float* u, const float* b,
                                    float* u_out, float* rc, const Grid3& g,
                                    const Grid3& gc, int steps,
                                    int first_step, int rbgs,
                                    const Weights& wt, const Op& op,
                                    cudaStream_t st, float* uc = nullptr) {
  static int configured[kMaxDevices] = {};
  const int halo = steps + 2;
  if (steps < 0 || first_step < 0 || halo > kMaxHalo3) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(smooth_restrict3_kernel<Op, Fas>,
                               kWindow3Bytes, configured);
  if (err != cudaSuccess) return err;
  const int tyz = kW3yz - 2 * halo;
  const dim3 grid(tiles(2 * gc.Sx, kW3x - 2 * halo), tiles(2 * gc.Sy, tyz),
                  tiles(2 * gc.Sz, tyz));
  smooth_restrict3_kernel<Op, Fas><<<grid, dim3(kW3x, kThreads3Y),
                                     kWindow3Bytes, st>>>(
      u, b, u_out, rc, uc, g, gc, steps, first_step, rbgs, wt, op);
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
