// The z-marching (2.5D) form of a 3D level visit's first kernel: `steps`
// smoothing steps, the residual r = b - A u', and its full-weighting
// restriction R = P^T / 2 masked to the coarse interior, in one launch,
// generic in the operator `Op`: vartransfer3d.cu's VarOp3 (K1v_3 and
// K1v_3-ext) and transfer3d.cu's ZConstOp3, the 7-point stencil (K1_3 and
// K1_3-ext).  It computes what levelvisit3.cuh's K1 computes, node for node
// in the same order; only the schedule differs.
//
// What bounds it: device-memory traffic, ~3 passes of the fine cube (u, b,
// u') for the 7-point stencil and ~6-9 with VarOp3's 3-6 coefficient
// planes, against ~10-25 flops per node and step.
// window3.cuh's fixed 24^2 x 32 window held a tile of 14^2 x 22 at
// Chebyshev 3 (4.3x the loads and node updates of the tile), ran every step
// over the whole window with a barrier each, and its three windows took
// 216 KB: one block per SM.
//
// What the design does about it:
// * Tiling.  A block owns a kZY x w (y, x) window, a tile of (kZY - 2h) x
//   (w - 2h) inside a halo of h = steps + 2 along y and x only, and marches
//   through a z-segment of 2 cz fine planes (cz coarse planes), plane by
//   plane.  w is 64 (two warps a row) up to kZWideSteps steps and 32 past
//   them, where the planes of a wide window would not fit in shared
//   memory; at Chebyshev 3 the tile is 22 x 54 of 32 x 64 cells.  Along z
//   the halo is a pipeline fill of 2h planes per segment; a segment is at
//   least kZMinSegment halos deep.
// * A wavefront over the steps.  At plane p, step s updates plane p - s
//   from step s - 1's planes p - s - 1, p - s and p - s + 1; the residual
//   is step steps + 1.  Each thread owns two (y, x) columns of the window
//   through every step: the z neighbours of its columns stay in its
//   registers, and each step's newest plane goes to a double-buffered shared
//   plane for the x and y neighbours of the next step.  Step s runs only on
//   the window rows it still holds valid ([s, kZY - s)), so each node is
//   updated once per step plus the xy halo, with one barrier per plane.
// * Coefficients from L1 (VarOp3; the 7-point stencil has none).  A step
//   reads a live node's couplings (the minus ones from the node one back)
//   through the read-only path and inverts its diagonal, as the window
//   did; the planes of a block's segment in flight stay in L1 between the
//   steps that read them.  Holding them in
//   a per-thread register queue instead (read once per node) took 128
//   registers at 3 steps and spilled: on a 32 x 32 window 9.7 ms against
//   7.7 with two blocks of 64-register threads per SM (PERF.md, PR 13).
// * Occupancy.  64 registers a thread: a wide window's 1024 threads (160
//   KB of shared memory at 3 steps) fill an SM, a narrow one's 512 half.
// * Residual and restriction last.  The residual planes go to a ring of
//   four; one plane later, FW restriction blurs planes 2I - 1, 2I, 2I + 1
//   along x, then y, then z, and halves, writing one coarse plane for every
//   two fine ones.  u' is written once, after the last step.
// * Copies overlap compute.  u and b of plane p + 1 arrive by cp.async into
//   rings while the block computes plane p.
//
// Masks, colours and placement come from Grid3 as in levelvisit3.cuh: the
// interior mask and the RB-GS parity in global coordinates, the coarse
// node I at fine 2I - hz, the coarse frame and the coarse tail past S/2
// zero, the coarse mask in global coarse coordinates.  Cells outside the
// array read 0.
//
// The operator provides `Coef couplings(gz, gy, gx)` (the couplings of a live
// node at array indices gz, gy, gx) and jacobi_n / gs_n / residual_n on a
// ZNbrs neighbourhood, in the plain versions' order.  The march is the
// device function zmarch_smooth_restrict3; the __global__ that calls it
// names the launch in a trace: zmarch_smooth_restrict3_kernel here,
// transfer3d.cu's zmarch::smooth_restrict3_kernel for K1_3.

#pragma once

#include "cpasync.cuh"
#include "window3.cuh"

namespace {

constexpr int kZX = 32;                    // window extent along x
constexpr int kZY = 32;                    // window extent along y
constexpr int kZThreadsY = 16;             // thread row wy: rows wy, wy + 16
constexpr int kZWideSteps = 5;             // deepest launch of a wide window
constexpr int kZMaxHalo = 11;              // leaves a tile of 10
constexpr int kZMaxSteps = kZMaxHalo - 2;
constexpr int kZMinSegment = 20;           // segment depth, in halos

// A node and its six neighbours at one step: v at (z, y, x), then x+1,
// x-1, y+1, y-1, z+1, z-1.
struct ZNbrs {
  float v, xp, xm, yp, ym, zp, zm;
};

// Jacobi weights per local step, expanded on the host (c1 = 1 - w, and the
// operator's c2), so that the unrolled steps read them at fixed offsets.
struct ZWeights {
  float c1[kZMaxSteps];
  float c2[kZMaxSteps];
};

// The window's extent along x: twice kZX (two warps a row) for launches of
// up to kZWideSteps steps, whose planes still fit in shared memory.
__host__ __device__ constexpr int zwidth(int steps) {
  return steps <= kZWideSteps ? 2 * kZX : kZX;
}

// Shared floats of a launch of `steps` steps: the u ring (4 planes), the b
// ring (steps + 3), two planes per step, the residual ring (4).
__host__ __device__ constexpr int zmarch_floats(int steps) {
  return (4 + (steps + 3) + 2 * steps + 4) * zwidth(steps) * kZY;
}

// The threads of a z-march block: two warps a row of a wide window.
constexpr int kZThreads = 2 * kZX * kZThreadsY;

// The march of one block, for a __global__ of launch bounds (kZThreads, 1)
// to call with its own parameters (taken by value, as the kernel takes
// them, so that an instance compiles as the kernel's body did).
template <typename Op, int STEPS>
__device__ __forceinline__ void zmarch_smooth_restrict3(
    const float* __restrict__ u, const float* __restrict__ b,
    float* __restrict__ u_out, float* __restrict__ rc, Grid3 g, Grid3 gc,
    int cz, int first_step, int rbgs, ZWeights wt, Op op) {
  constexpr int H = STEPS + 2;
  constexpr int WX = zwidth(STEPS);
  constexpr int PL = WX * kZY;                // one plane of the window
  constexpr int NT = WX * kZThreadsY;         // threads
  constexpr int TY = kZY - 2 * H;             // the tile along y and x
  constexpr int TX = WX - 2 * H;
  constexpr int CY = TY / 2;
  constexpr int CX = TX / 2;
  constexpr int RB = STEPS + 3;
  extern __shared__ float smem[];
  float* ring_u = smem;
  float* ring_b = ring_u + 4 * PL;
  float* stage = ring_b + RB * PL;
  float* res = stage + 2 * STEPS * PL;
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * WX + lane;

  // The blocks tile the coarse array: coarse (I0.., J0.., K0..) has its
  // fine tile at (2 I0 - hz, 2 J0 - hy, 2 K0).
  const int I0 = blockIdx.z * cz;
  const int J0 = blockIdx.y * CY;
  const int K0 = blockIdx.x * CX;
  const int Z0 = 2 * I0 - g.hz;
  const int Z1 = Z0 + 2 * cz;
  const int yo = 2 * J0 - g.hy;
  const int xo = 2 * K0;
  if (Z0 >= g.Sz || Z1 <= 0 || yo >= g.Sy || yo + TY <= 0 || xo >= g.Sx) {
    // No fine node of the array in the tile: its coarse nodes are zero.
    for (int i = tid; i < cz * CY * CX; i += NT) {
      const int K = K0 + i % CX;
      const int J = J0 + (i / CX) % CY;
      const int I = I0 + i / (CY * CX);
      if (I < gc.Sz && J < gc.Sy && K < gc.Sx) rc[gidx(gc, I, J, K)] = 0.0f;
    }
    return;
  }

  const int y0 = yo - H;
  const int gx = xo - H + lane;
  const bool x_live = gx >= 1 && gx <= g.n - 1 && gx < g.Sx;
  const bool x_arr = gx >= 0 && gx < g.Sx;
  const bool x_tile = lane >= H && lane < H + TX;
  int row[2], gy[2], par[2], kw[2];
  bool xy_live[2], xy_arr[2], in_tile[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    row[c] = wy + c * kZThreadsY;
    gy[c] = y0 + row[c];
    const bool y_arr = gy[c] >= 0 && gy[c] < g.Sy;
    xy_arr[c] = x_arr && y_arr;
    xy_live[c] = x_live && y_arr && gy[c] + g.oy >= 1 &&
                 gy[c] + g.oy <= g.n - 1;
    in_tile[c] = xy_arr[c] && x_tile && row[c] >= H && row[c] < H + TY;
    par[c] = (gy[c] + g.oy + gx) & 1;
    kw[c] = row[c] * WX + lane;
  }
  auto live = [&](int z, int c) {
    return xy_live[c] && z >= 0 && z < g.Sz && z + g.oz >= 1 &&
           z + g.oz <= g.n - 1;
  };

  for (int i = tid; i < zmarch_floats(STEPS); i += NT) smem[i] = 0.0f;
  __syncthreads();

  // Plane z of u and b into ring slot i, each thread its own two cells.
  auto issue = [&](int z, int i) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool ok = xy_arr[c] && z >= 0 && z < g.Sz;
      const size_t o = ok ? gidx(g, z, gy[c], gx) : 0;
      cp_async4(ring_u + (i & 3) * PL + kw[c], u + o, ok);
      cp_async4(ring_b + (i % RB) * PL + kw[c], b + o, ok);
    }
  };

  // Step t's values (t >= 1) one and two planes behind its newest.
  float prv[STEPS + 1][2];
  float cur[STEPS + 1][2];
#pragma unroll
  for (int t = 0; t <= STEPS; ++t) {
    prv[t][0] = prv[t][1] = cur[t][0] = cur[t][1] = 0.0f;
  }

  const int zs = Z0 - H;
  const int iters = (Z1 - Z0) + 2 * H;        // planes zs .. Z1 + steps + 1
  const int nc = g.n / 2;
  issue(zs, 0);
  cp_async_commit();
  for (int i = 0; i < iters; ++i) {
    const int p = zs + i;
    cp_async_wait<0>();
    __syncthreads();         // plane p has landed; plane p - 1's steps done
    if (i + 1 < iters) issue(p + 1, i + 1);
    cp_async_commit();

    float nw[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) nw[c] = ring_u[(i & 3) * PL + kw[c]];
#pragma unroll
    for (int s = 1; s <= STEPS; ++s) {
      // Step s (local step s - 1) updates plane z = p - s.
      const int z = p - s;
      const float* ctr =
          s == 1 ? ring_u + ((i - 1) & 3) * PL
                 : stage + (2 * (s - 2) + ((i - 1) & 1)) * PL;
      const float* bz = ring_b + ((i - s + RB) % RB) * PL;
      float* dst = stage + (2 * (s - 1) + (i & 1)) * PL;
      const int color = (first_step + s - 1) & 1;
      const float c1 = wt.c1[s - 1];
      const float c2 = wt.c2[s - 1];
      float out[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = kw[c];
        const float v = s == 1 ? ctr[k] : cur[s - 1][c];
        out[c] = v;
        if (row[c] >= s && row[c] < kZY - s && lane >= s &&
            lane < WX - s) {
          if (live(z, c)) {
            const float zm =
                s == 1 ? ring_u[((i - 2) & 3) * PL + k] : prv[s - 1][c];
            const ZNbrs nb{v,          ctr[k + 1],       ctr[k - 1],
                           ctr[k + WX], ctr[k - WX], nw[c], zm};
            if (!rbgs) {
              out[c] = op.jacobi_n(op.couplings(z, gy[c], gx), nb, bz[k],
                                   c1, c2);
            } else if (((z + g.oz + par[c]) & 1) == color) {
              out[c] = op.gs_n(op.couplings(z, gy[c], gx), nb, bz[k]);
            }
          } else if (!rbgs) {
            out[c] = 0.0f;
          }
          dst[k] = out[c];
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (s >= 2) {
          prv[s - 1][c] = cur[s - 1][c];
          cur[s - 1][c] = nw[c];
        }
        nw[c] = out[c];
      }
    }

    // nw is u' at plane p - steps.
    const int zo = p - STEPS;
    if (zo >= Z0 && zo < Z1 && zo >= 0 && zo < g.Sz) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (in_tile[c]) u_out[gidx(g, zo, gy[c], gx)] = nw[c];
      }
    }

    // The residual at plane p - steps - 1, on the tile plus one layer.
    {
      const int z = zo - 1;
      const float* ctr =
          STEPS == 0 ? ring_u + ((i - 1) & 3) * PL
                     : stage + (2 * (STEPS - 1) + ((i - 1) & 1)) * PL;
      const float* bz = ring_b + ((i - STEPS - 1 + RB) % RB) * PL;
      float* dst = res + (i & 3) * PL;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = kw[c];
        if (row[c] >= H - 1 && row[c] <= H + TY && lane >= H - 1 &&
            lane <= H + TX) {
          float r = 0.0f;
          if (live(z, c)) {
            const float v = STEPS == 0 ? ctr[k] : cur[STEPS][c];
            const float zm = STEPS == 0
                                 ? ring_u[((i - 2) & 3) * PL + k]
                                 : prv[STEPS][c];
            const ZNbrs nb{v,          ctr[k + 1],       ctr[k - 1],
                           ctr[k + WX], ctr[k - WX], nw[c], zm};
            r = op.residual_n(op.couplings(z, gy[c], gx), nb, bz[k]);
          }
          dst[k] = r;
        }
        if (STEPS > 0) {
          prv[STEPS][c] = cur[STEPS][c];
          cur[STEPS][c] = nw[c];
        }
      }
    }

    // R = P^T / 2 at coarse plane I, fine plane zc = 2I - hz, from the
    // residual planes zc - 1, zc, zc + 1 (computed at the three planes
    // before this one): blur x, then y, then z, halve.  A coarse node
    // whose fine node lies outside the array is zero.
    const int zc = zo - 3;
    if (zc >= Z0 && zc < Z1 && ((zc - Z0) & 1) == 0 && tid < CY * CX) {
      const int cj = tid / CX;
      const int ck = tid - cj * CX;
      const int I = I0 + (zc - Z0) / 2;
      const int J = J0 + cj;
      const int K = K0 + ck;
      if (I < gc.Sz && J < gc.Sy && K < gc.Sx) {
        float val = 0.0f;
        if (in_array3(g, zc, yo + 2 * cj, xo + 2 * ck) &&
            interior3(I + gc.oz, J + gc.oy, K, nc)) {
          const int k = (H + 2 * cj) * WX + H + 2 * ck;
          const float* lo = res + ((i - 3) & 3) * PL;
          const float* mid = res + ((i - 2) & 3) * PL;
          const float* hi = res + ((i - 1) & 3) * PL;
          auto t1 = [&](const float* r, int q) {
            return r[q] + 0.5f * (r[q - 1] + r[q + 1]);
          };
          auto t2 = [&](const float* r) {
            return t1(r, k) + 0.5f * (t1(r, k - WX) + t1(r, k + WX));
          };
          val = 0.5f * (t2(mid) + 0.5f * (t2(lo) + t2(hi)));
        }
        rc[gidx(gc, I, J, K)] = val;
      }
    }
  }
}

template <typename Op, int STEPS>
__global__ void __launch_bounds__(kZThreads, 1)
zmarch_smooth_restrict3_kernel(const float* __restrict__ u,
                               const float* __restrict__ b,
                               float* __restrict__ u_out,
                               float* __restrict__ rc, Grid3 g, Grid3 gc,
                               int cz, int first_step, int rbgs, ZWeights wt,
                               Op op) {
  zmarch_smooth_restrict3<Op, STEPS>(u, b, u_out, rc, g, gc, cz, first_step,
                                     rbgs, wt, op);
}

template <typename Op>
using ZKernel = void (*)(const float*, const float*, float*, float*, Grid3,
                         Grid3, int, int, int, ZWeights, Op);

// zmarch_smooth_restrict3_kernel<Op, steps>, for 0 <= steps <= S.
template <typename Op, int S>
ZKernel<Op> zmarch_kernel(int steps) {
  if (steps == S) return zmarch_smooth_restrict3_kernel<Op, S>;
  if constexpr (S > 0) {
    return zmarch_kernel<Op, S - 1>(steps);
  } else {
    return nullptr;
  }
}

// Coarse planes per z-segment: the fine planes that hold the array's nodes
// (from the first coarse plane's, 2 * 0 - hz) cut into segments of at least
// kZMinSegment halos, as evenly as they go.
inline int zmarch_segment(const Grid3& g, int halo) {
  const int extent = g.Sz + g.hz;
  int segments = extent / (kZMinSegment * halo);
  if (segments < 1) segments = 1;
  const int planes = (extent + 1) / 2;
  return (planes + segments - 1) / segments;
}

// One z-march launch of `steps` steps starting at global step `first_step`
// on the grids g / gc.  weights: host [c1[0..count), c2[0..count)], local
// step s taking entry s % count.  The grid covers the coarse array, so
// that the coarse tail past S/2, or a block's coarse frame, is zeroed too.
// kernel_of(steps) picks the __global__ (one family of them per Op).
template <typename Op>
cudaError_t launch_zmarch_smooth_restrict3(
    const float* u, const float* b, float* u_out, float* rc, const Grid3& g,
    const Grid3& gc, int steps, int first_step, int rbgs,
    const float* weights, int count, const Op& op, cudaStream_t st,
    ZKernel<Op> (*kernel_of)(int) = zmarch_kernel<Op, kZMaxSteps>) {
  static int configured[kZMaxSteps + 1][kMaxDevices] = {};
  if (steps < 0 || steps > kZMaxSteps || first_step < 0 || count < 1 ||
      count > kMaxWeights) {
    return cudaErrorInvalidValue;
  }
  ZWeights wt;
  for (int j = 0; j < kZMaxSteps; ++j) {
    wt.c1[j] = weights[j % count];
    wt.c2[j] = weights[count + j % count];
  }
  const ZKernel<Op> kernel = kernel_of(steps);
  const int bytes = zmarch_floats(steps) * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(kernel, bytes, configured[steps]);
  if (err != cudaSuccess) return err;
  const int halo = steps + 2;
  const int cy = (kZY - 2 * halo) / 2;
  const int cx = (zwidth(steps) - 2 * halo) / 2;
  const int cz = zmarch_segment(g, halo);
  const dim3 grid(tiles(gc.Sx, cx), tiles(gc.Sy, cy), tiles(gc.Sz, cz));
  kernel<<<grid, dim3(zwidth(steps), kZThreadsY), bytes, st>>>(
      u, b, u_out, rc, g, gc, cz, first_step, rbgs, wt, op);
  return cudaGetLastError();
}

}  // namespace
