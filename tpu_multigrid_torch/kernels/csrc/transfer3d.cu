// K1_3 (smooth_restrict3) and K2_3 (prolong_smooth3, prolong_smooth_
// resnorm3): the two kernels of a 3D multigrid level visit, for Hopper
// (sm_90a), on the 7-point Poisson stencil or on a static 3x3x3 stencil
// (the 19-point Mehrstellen operator).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/transfer3d.py::
// _smooth_restrict3 (K1_3) and ::_prolong_smooth3 (K2_3).
//
//   K1_3: `steps` Jacobi (per-step weights) or RB-GS steps on u, then
//         r = b - A u, then the full-weighting restriction R = P^T / 2 of r
//         to the coarse grid, masked to the coarse interior; the coarse
//         nodes past S/2 along any axis are zero.  Writes u' and rc.
//   K2_3: u <- mask(u + P ec) with trilinear P, then `steps` smoothing
//         steps.  Writes u'; the resnorm variant also writes one partial sum
//         of (b - A u')^2 per block, which a one-block kernel adds up.
//
// What bounds them: device-memory traffic.  K1_3 reads u and b and writes
// u' and the eighth-size rc; K2_3 reads u, b and the eighth-size ec and
// writes u': about 3.1 passes of the fine cube each, against ~10 flops per
// node and step (~40 with the 19-point stencil), far below the card's
// flop-per-byte balance.  Unfused, every sweep, the residual and each
// transfer would be passes of their own.
//
// What the design does about it: the 3D window of window3.cuh, one block
// per fine tile, with a halo of steps + 2 layers for K1_3 (each step
// invalidates one layer, the residual and the blur need two more) and
// steps + 1 for K2_3 with the resnorm (steps without it).  The tile sides
// are even, so a tile's coarse nodes are the even nodes of the tile: the
// restriction reads the residual from shared memory.  K2_3 evaluates P ec
// at every window cell straight from device memory (the eighth-size ec is
// served mostly from L1/L2).  The halo costs redundant loads and steps: at
// Chebyshev 3 a K1_3 tile of 14^2 x 22 sits in a 24^2 x 32 window.  A
// window deeper than kMaxHalo3 does not fit and the launch is refused.
//
// Arithmetic: the Pallas kernels' order, as kernels/transfer3d.py's plain
// versions repeat it: the restriction blurs x, then y, then z and halves;
// the prolongation averages x, then y, then z.  Built with -fmad=false: u'
// and rc match the plain versions bitwise.  The resnorm partials are summed
// in a fixed tree order with no atomics, so the norm repeats run to run.

#include "levelvisit.cuh"
#include "window3.cuh"

namespace {

template <bool S27>
__global__ void __launch_bounds__(kThreads3)
smooth_restrict3_kernel(const float* __restrict__ u,
                        const float* __restrict__ b,
                        float* __restrict__ u_out, float* __restrict__ rc,
                        Grid3 g, Grid3 gc, int steps, int rbgs, Weights wt,
                        Taps tp) {
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

  const float* v = smooth3<S27>(buf_a, buf_b, bw, z0, y0, x0, g.n, steps, 0,
                                rbgs, wt, tp);
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
    r[k] = interior3(gz, gy, gx, g.n) ? residual3_at<S27>(v, bw, k, tp)
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

template <bool S27>
__global__ void __launch_bounds__(kThreads3)
prolong_smooth3_kernel(const float* __restrict__ u,
                       const float* __restrict__ b,
                       const float* __restrict__ ec,
                       float* __restrict__ u_out,
                       float* __restrict__ partials, Grid3 g, Grid3 gc,
                       int steps, int rbgs, Weights wt, Taps tp) {
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
  for (int row = threadIdx.y; row < kW3Rows; row += blockDim.y) {
    int lz, ly;
    row_coords(row, lz, ly);
    const int gz = z0 + lz;
    const int gy = y0 + ly;
    const int k = row * kW3x + lx;
    const bool in_arr = in_array3(g, gz, gy, gx);
    buf_a[k] = interior3(gz, gy, gx, g.n)
                   ? u[gidx(g, gz, gy, gx)] +
                         prolong3_at(ec, gc, mz, my, mx, gz, gy, gx)
                   : 0.0f;
    bw[k] = in_arr ? b[gidx(g, gz, gy, gx)] : 0.0f;
  }
  __syncthreads();

  const float* v = smooth3<S27>(buf_a, buf_b, bw, z0, y0, x0, g.n, steps, 0,
                                rbgs, wt, tp);

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
      const float rr = residual3_at<S27>(v, bw, k, tp);
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

// Opts every instantiation in to the window's shared memory, once per
// device.
template <typename Kernel>
cudaError_t allow_window3(Kernel kernel, int* configured) {
  return allow_smem(kernel, kWindow3Bytes, configured);
}

}  // namespace

extern "C" {

int tmt_window3_max_halo(void) { return kMaxHalo3; }

// weights: host array [c1[0..count), c2[0..count)] (RB-GS: c2[0] is its
// coefficient).  taps: host array [dz, dy, dx, w] * ntaps + [centre], or
// ntaps 0 for the 7-point stencil.  The grid covers 2 * Sc along each axis
// (>= S) so that the coarse tail past S/2 is zeroed too.
int tmt_smooth_restrict3(const void* u, const void* b, void* u_out, void* rc,
                         int Sz, int Sy, int Sx, int Szc, int Syc, int Scx,
                         int n, int steps, int rbgs, const void* weights,
                         int count, const void* taps, int ntaps,
                         void* stream) {
  static int configured[2][kMaxDevices] = {};
  const int halo = steps + 2;
  if (steps < 0 || halo > kMaxHalo3) return cudaErrorInvalidValue;
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  Taps tp;
  err = make_taps(static_cast<const float*>(taps), ntaps, &tp);
  if (err != cudaSuccess) return err;
  const int tyz = kW3yz - 2 * halo;
  const dim3 grid(tiles(2 * Scx, kW3x - 2 * halo), tiles(2 * Syc, tyz),
                  tiles(2 * Szc, tyz));
  const Grid3 g{Sz, Sy, Sx, n};
  const Grid3 gc{Szc, Syc, Scx, n / 2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  if (ntaps > 0) {
    err = allow_window3(smooth_restrict3_kernel<true>, configured[1]);
    if (err != cudaSuccess) return err;
    smooth_restrict3_kernel<true>
        <<<grid, dim3(kW3x, kThreads3Y), kWindow3Bytes, st>>>(
            uu, bb, static_cast<float*>(u_out), static_cast<float*>(rc), g,
            gc, steps, rbgs, wt, tp);
  } else {
    err = allow_window3(smooth_restrict3_kernel<false>, configured[0]);
    if (err != cudaSuccess) return err;
    smooth_restrict3_kernel<false>
        <<<grid, dim3(kW3x, kThreads3Y), kWindow3Bytes, st>>>(
            uu, bb, static_cast<float*>(u_out), static_cast<float*>(rc), g,
            gc, steps, rbgs, wt, tp);
  }
  return cudaGetLastError();
}

// The number of blocks, and so of resnorm partials, of one prolong_smooth3
// launch with the resnorm.
int tmt_prolong_smooth3_blocks(int Sz, int Sy, int Sx, int steps) {
  const int halo = steps + 1;
  const int tyz = kW3yz - 2 * halo;
  return tiles(Sx, kW3x - 2 * halo) * tiles(Sy, tyz) * tiles(Sz, tyz);
}

// partials: tmt_prolong_smooth3_blocks floats, or null for no resnorm; then
// out_sum[0] receives the sum of (b - A u')^2 over the interior.
int tmt_prolong_smooth3(const void* u, const void* b, const void* ec,
                        void* u_out, void* partials, void* out_sum, int Sz,
                        int Sy, int Sx, int Szc, int Syc, int Scx, int n,
                        int steps, int rbgs, const void* weights, int count,
                        const void* taps, int ntaps, void* stream) {
  static int configured[2][kMaxDevices] = {};
  const int halo = steps + (partials != nullptr ? 1 : 0);
  if (steps < 0 || halo > kMaxHalo3) return cudaErrorInvalidValue;
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  Taps tp;
  err = make_taps(static_cast<const float*>(taps), ntaps, &tp);
  if (err != cudaSuccess) return err;
  const int tyz = kW3yz - 2 * halo;
  const dim3 grid(tiles(Sx, kW3x - 2 * halo), tiles(Sy, tyz), tiles(Sz, tyz));
  const Grid3 g{Sz, Sy, Sx, n};
  const Grid3 gc{Szc, Syc, Scx, n / 2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  const float* cc = static_cast<const float*>(ec);
  float* out = static_cast<float*>(u_out);
  float* part = static_cast<float*>(partials);
  if (ntaps > 0) {
    err = allow_window3(prolong_smooth3_kernel<true>, configured[1]);
    if (err != cudaSuccess) return err;
    prolong_smooth3_kernel<true>
        <<<grid, dim3(kW3x, kThreads3Y), kWindow3Bytes, st>>>(
            uu, bb, cc, out, part, g, gc, steps, rbgs, wt, tp);
  } else {
    err = allow_window3(prolong_smooth3_kernel<false>, configured[0]);
    if (err != cudaSuccess) return err;
    prolong_smooth3_kernel<false>
        <<<grid, dim3(kW3x, kThreads3Y), kWindow3Bytes, st>>>(
            uu, bb, cc, out, part, g, gc, steps, rbgs, wt, tp);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || partials == nullptr) return err;
  sum_partials_kernel<<<1, dim3(kThreadsX, kThreadsY), 0, st>>>(
      part, static_cast<int>(grid.x * grid.y * grid.z),
      static_cast<float*>(out_sum));
  return cudaGetLastError();
}

}  // extern "C"
