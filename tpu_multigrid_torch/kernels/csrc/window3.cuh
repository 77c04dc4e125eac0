// Shared-memory window machinery of the 3D kernels (stencil3d.cu, and
// through levelvisit3.cuh transfer3d.cu, fas3d.cu and vartransfer3d.cu's
// K2v_3; K1v_3 and the 7-point K1_3 march through z instead, zmarch3.cuh,
// on the Grid3 and masks here): a block loads
// a fixed kW3yz x kW3yz x kW3x window (z, y, x) of the grid into shared
// memory, runs its smoothing steps there and writes the tile that lies
// `halo` cells inside the window's faces (ghost-zone temporal blocking:
// each step invalidates one layer of the window, and the halo is deep
// enough that no invalid cell reaches an output).  The window is fixed
// and the tile shrinks with the halo: (kW3yz - 2 halo)^2 x (kW3x - 2 halo)
// outputs per block.
//
// Layout: one warp spans a window row along x (kW3x = 32 lanes), so every
// global load and store of a row is one coalesced access; the 16 warps of a
// block stride over the kW3yz^2 rows.  Three f32 windows (the iterate, its
// double buffer, b) take 216 KB: one block per SM.
//
// The smoothing loop is generic in the operator (ConstOp3 here, VarOp3 in
// vartransfer3d.cu for K2v_3), which it calls at interior nodes only.
//
// Arithmetic: the Pallas kernels' order (tpu_multigrid/kernels/
// stencil3d.py), which the plain versions in kernels/stencil3d.py repeat,
// built with -fmad=false so that nothing is contracted into an FMA.  Cells
// outside the array read as zero and are never updated; the interior mask
// and the RB-GS parity come from global indices (a Grid3's origin plus the
// array index).  Array offsets are 64-bit.

#pragma once

#include "window.cuh"

namespace {

constexpr int kW3x = 32;                    // window extent along x
constexpr int kW3yz = 24;                   // window extent along y and z
constexpr int kW3Plane = kW3x * kW3yz;      // window stride of z
constexpr int kW3Rows = kW3yz * kW3yz;      // (z, y) rows of a window
constexpr int kW3Cells = kW3Rows * kW3x;
constexpr int kThreads3Y = 16;
constexpr int kThreads3 = kW3x * kThreads3Y;
// The deepest halo that leaves a tile of 2 along y and z.
constexpr int kMaxHalo3 = kW3yz / 2 - 1;
constexpr int kMaxTaps = 26;
constexpr int kWindow3Bytes = 3 * kW3Cells * static_cast<int>(sizeof(float));

// An (Sz, Sy, Sx) array whose unknowns are the global interior 1..n-1.  A
// whole padded level has origin and ghost widths 0.  A ghost-extended block
// of a decomposed grid (the distributed tier, local3 entries of
// transfer3d.cu and vartransfer3d.cu) has its cell (0, 0, 0) at global
// (oz, oy, 0) and an owned region inside hz ghost planes and hy ghost rows
// a side; its coarse block holds fine cell (z, y) (both even) at coarse
// (z / 2 + hz / 2, y / 2 + hy / 2).
struct Grid3 {
  int Sz, Sy, Sx, n;
  int oz = 0, oy = 0;
  int hz = 0, hy = 0;
};

// A static 3x3x3 stencil's off-diagonal taps, in the order they are summed
// (the Pallas kernel's: (dz, dy, dx) lexicographic, zeros and the centre
// skipped), as window offsets; `diag` is the centre weight.  count == 0
// selects the 7-point Poisson stencil instead.
struct Taps {
  int count;
  int off[kMaxTaps];
  float w[kMaxTaps];
  float diag;
};

// host: [dz, dy, dx, w] per tap, then the centre weight.
cudaError_t make_taps(const float* host, int count, Taps* tp) {
  if (count < 0 || count > kMaxTaps) return cudaErrorInvalidValue;
  tp->count = count;
  for (int i = 0; i < kMaxTaps; ++i) {
    tp->off[i] = 0;
    tp->w[i] = 0.0f;
  }
  for (int i = 0; i < count; ++i) {
    const int dz = static_cast<int>(host[4 * i]);
    const int dy = static_cast<int>(host[4 * i + 1]);
    const int dx = static_cast<int>(host[4 * i + 2]);
    tp->off[i] = dz * kW3Plane + dy * kW3x + dx;
    tp->w[i] = host[4 * i + 3];
  }
  tp->diag = count > 0 ? host[4 * count] : 6.0f;
  return cudaSuccess;
}

__device__ __forceinline__ size_t gidx(const Grid3& g, int z, int y, int x) {
  return (static_cast<size_t>(z) * g.Sy + y) * g.Sx + x;
}

__device__ __forceinline__ bool in_array3(const Grid3& g, int z, int y,
                                          int x) {
  return z >= 0 && z < g.Sz && y >= 0 && y < g.Sy && x >= 0 && x < g.Sx;
}

__device__ __forceinline__ bool interior3(int z, int y, int x, int n) {
  return z >= 1 && z <= n - 1 && y >= 1 && y <= n - 1 && x >= 1 &&
         x <= n - 1;
}

// Whether array cell (z, y, x) is an unknown: in the array, and inside the
// global interior.
__device__ __forceinline__ bool live3(const Grid3& g, int z, int y, int x) {
  return in_array3(g, z, y, x) && interior3(z + g.oz, y + g.oy, x, g.n);
}

// The RB-GS colour of array cell (z, y, x): the parity of its global
// indices.
__device__ __forceinline__ int color3(const Grid3& g, int z, int y, int x) {
  return (z + g.oz + y + g.oy + x) & 1;
}

// x-1, x+1, y-1, y+1, z-1, z+1: the Pallas kernel's neighbour order.
__device__ __forceinline__ float nbr7(const float* v, int k) {
  return ((((v[k - 1] + v[k + 1]) + v[k - kW3x]) + v[k + kW3x]) +
          v[k - kW3Plane]) +
         v[k + kW3Plane];
}

// sum of w[t] * v[k + off[t]] over the taps, from the first term.
__device__ __forceinline__ float off27(const float* v, int k, const Taps& tp) {
  float out = tp.w[0] * v[k + tp.off[0]];
  for (int t = 1; t < tp.count; ++t) out = out + tp.w[t] * v[k + tp.off[t]];
  return out;
}

// b - A v at window index k: (b - 6v) + nbr, or (b - diag v) - off.
template <bool S27>
__device__ __forceinline__ float residual3_at(const float* v, const float* bw,
                                              int k, const Taps& tp) {
  if (S27) return (bw[k] - tp.diag * v[k]) - off27(v, k, tp);
  return (bw[k] - 6.0f * v[k]) + nbr7(v, k);
}

// Window row `row` = lz * kW3yz + ly.
__device__ __forceinline__ void row_coords(int row, int& lz, int& ly) {
  lz = row / kW3yz;
  ly = row - lz * kW3yz;
}

// The window at global origin (z0, y0, x0); cells outside the array read 0.
__device__ void load_window3(float* dst, const float* __restrict__ src,
                             const Grid3& g, int z0, int y0, int x0) {
  const int gx = x0 + threadIdx.x;
#pragma unroll 4
  for (int row = threadIdx.y; row < kW3Rows; row += blockDim.y) {
    int lz, ly;
    row_coords(row, lz, ly);
    const int gz = z0 + lz;
    const int gy = y0 + ly;
    dst[row * kW3x + threadIdx.x] =
        in_array3(g, gz, gy, gx) ? src[gidx(g, gz, gy, gx)] : 0.0f;
  }
}

// The constant operator of a window: the 7-point Poisson stencil, or static
// 3x3x3 weights (S27).  The smoothing and level-visit templates call
// jacobi / gs / residual at live nodes only; `gz, gy, gx` are the node's
// array indices (unused here).
template <bool S27>
struct ConstOp3 {
  Taps tp;

  __device__ __forceinline__ float f(const float* v, const float* bw,
                                     int k) const {
    return S27 ? bw[k] - off27(v, k, tp) : bw[k] + nbr7(v, k);
  }
  // c1 v + c2 (b + nbr) or c1 v + c2 (b - off).
  __device__ __forceinline__ float jacobi(const float* v, const float* bw,
                                          int k, int, int, int, float c1,
                                          float c2) const {
    return c1 * v[k] + c2 * f(v, bw, k);
  }
  __device__ __forceinline__ float gs(const float* v, const float* bw, int k,
                                      int, int, int, float c2) const {
    return c2 * f(v, bw, k);
  }
  __device__ __forceinline__ float residual(const float* v, const float* bw,
                                            int k, int, int, int) const {
    return residual3_at<S27>(v, bw, k, tp);
  }
};

// Runs `steps` steps of `op` on the window at array origin (z0, y0, x0) of
// `g`, each from the state before it into the other buffer; returns the
// buffer that holds the result (the other one is free).  Jacobi local step
// s uses weights s % count and writes 0 at every cell that is not live.
// RB-GS half-step s updates the live nodes of colour (first_step + s) % 2
// and keeps every other node.  The outermost layer has no neighbours in the
// window and keeps its value: it is invalid after the first step.
template <typename Op>
__device__ float* smooth3(float* v, float* spare, const float* bw,
                          const Grid3& g, int z0, int y0, int x0, int steps,
                          int first_step, int rbgs, const Weights& wt,
                          const Op& op) {
  const int lx = threadIdx.x;
  const int gx = x0 + lx;
  const bool x_inner = lx > 0 && lx < kW3x - 1;
  const bool x_in = gx >= 1 && gx <= g.n - 1;
  for (int s = 0; s < steps; ++s) {
    const float c1 = wt.c1[s % wt.count];
    const float c2 = wt.c2[s % wt.count];
    const int color = (first_step + s) & 1;
    for (int row = threadIdx.y; row < kW3Rows; row += blockDim.y) {
      int lz, ly;
      row_coords(row, lz, ly);
      const int k = row * kW3x + lx;
      float out = v[k];
      if (x_inner && lz > 0 && lz < kW3yz - 1 && ly > 0 && ly < kW3yz - 1) {
        const int gz = z0 + lz;
        const int gy = y0 + ly;
        const int wz = gz + g.oz;
        const int wy = gy + g.oy;
        const bool inter = x_in && gz >= 0 && gz < g.Sz && gy >= 0 &&
                           gy < g.Sy && wz >= 1 && wz <= g.n - 1 &&
                           wy >= 1 && wy <= g.n - 1;
        if (rbgs) {
          if (inter && color3(g, gz, gy, gx) == color) {
            out = op.gs(v, bw, k, gz, gy, gx, c2);
          }
        } else {
          out = inter ? op.jacobi(v, bw, k, gz, gy, gx, c1, c2) : 0.0f;
        }
      }
      spare[k] = out;
    }
    __syncthreads();
    float* t = v;
    v = spare;
    spare = t;
  }
  return v;
}

// The block's sum of `acc` in a fixed tree order; `red` holds kThreads3
// floats.
__device__ float block_sum3(float acc, float* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  __syncthreads();
  red[tid] = acc;
  __syncthreads();
  for (int s = kThreads3 / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

// Tiles along each axis that cover `extent` cells with tiles of `tile`.
inline int tiles(int extent, int tile) { return (extent + tile - 1) / tile; }

}  // namespace
