// Compensated residuals of a double-single or triple-single iterate, for
// Hopper (sm_90a); and the 3D flux stencil's residual in float64 (its own
// section below).
//
// Replaces the Pallas TPU kernel tpu_multigrid/kernels/compres.py::
// _comp_residual, both its entries:
//
//   ds: r = b - A(u_hi + u_lo)          to ~eps^2
//   ts: r = b - A(u_hi + u_mid + u_lo)  to ~eps^3
//
// with A the FEM-scaled 5-point stencil, masked to the interior 1..n-1.
//
// What bounds it: device-memory traffic.  One pass each over b and the 2 or
// 3 components and one written r: 4 or 5 passes of S*S*4 bytes, against
// ~50-90 flops per node.  The plain torch version materialises a dozen
// full-size temporaries (rolls and TwoSum terms), each a pass of its own.
//
// What the design does about it: one thread per node reads its node and four
// neighbours of each component straight from device memory (the neighbours
// are served by L1/L2, adjacent threads share them) and runs the whole TwoSum
// cascade in registers, so each input is read from device memory about once
// and r is written once.
//
// Arithmetic: TwoSum is exact IEEE arithmetic, so every operation goes
// through __fadd_rn/__fsub_rn/__fmul_rn, which the compiler neither
// contracts into an FMA nor reassociates, in the order of
// tpu_multigrid_torch/precision.py::_ds_cascade / _ts_cascade (compsum.cuh):
// r agrees with the plain torch version bitwise.
//
// The 3D entries (ds_residual3, ts_residual3): the same residuals of the
// 7-point operator on an (Sz, Sy, Sx) grid, masked to 1..n-1 on every axis.
// They replace no TPU kernel: the JAX package evaluates its 3D compensated
// residual in jnp.  They were added because the plain torch version (six
// rolls a neighbour sum, a dozen full-size TwoSum temporaries) took 79 ms a
// call at (528, 528, 640) on an H100, two thirds of a refined 513^3 solve.
//
// What bounds them: device-memory traffic.  b and the 2 or 3 components read
// and r written: 4 or 5 passes of Sz*Sy*Sx*4 bytes (0.85 / 1.07 ms at
// (528, 528, 640) on 3.35 TB/s; 0.69 / 0.85 ms counting only the cells the
// interior reads, 0..n on every axis), against 97 / 180 flops per node.
//
// What the design does about it (a column march): a block of 64 x 4 threads
// covers a 4 x 64 (y, x) tile of 8 planes, each thread one (y, x) column of
// them.  The thread keeps its column's values at z - 1, z and z + 1 in
// registers, so each centre it reads serves three planes; the x and y
// neighbours come through L1 from the block's own rows, and the blocks run
// z-major, so the rows of the tiles beside them and the planes above and
// below meet in L2.  So every input cell is read from device memory about
// once, and r is written once, coalesced, with the zeros of the masked nodes
// and the padding in the same pass.  Cells outside 0..n on some axis are
// never read.  A z march through shared planes filled by cp.async, 16 x 64
// tiles of 64 planes, ran 1.27 / 1.84 ms at (528, 528, 640) against this
// design's 0.87 / 1.34: its 80-100 registers a thread left one block of 16
// warps per SM (PERF.md §6, row 33).

#include <cuda_runtime.h>

#include "compsum.cuh"

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

// x's four neighbours of node k (up, down, left, right).
__device__ __forceinline__ void nbrs(const float* __restrict__ x, size_t k,
                                     int S, float n[4]) {
  n[0] = __ldg(x + k - S);
  n[1] = __ldg(x + k + S);
  n[2] = __ldg(x + k - 1);
  n[3] = __ldg(x + k + 1);
}

__global__ void ds_residual_kernel(const float* __restrict__ b,
                                   const float* __restrict__ uh,
                                   const float* __restrict__ ul,
                                   float* __restrict__ r, int S, int n) {
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S || j >= S) return;
  const size_t k = (size_t)i * S + j;
  if (!(i >= 1 && i <= n - 1 && j >= 1 && j <= n - 1)) {
    r[k] = 0.0f;
    return;
  }
  float nh[4], nl[4];
  nbrs(uh, k, S, nh);
  nbrs(ul, k, S, nl);
  r[k] = ds_resid(__ldg(b + k), __ldg(uh + k), nh, __ldg(ul + k), nl);
}

__global__ void ts_residual_kernel(const float* __restrict__ b,
                                   const float* __restrict__ uh,
                                   const float* __restrict__ um,
                                   const float* __restrict__ ul,
                                   float* __restrict__ r, int S, int n) {
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S || j >= S) return;
  const size_t k = (size_t)i * S + j;
  if (!(i >= 1 && i <= n - 1 && j >= 1 && j <= n - 1)) {
    r[k] = 0.0f;
    return;
  }
  float nh[4], nm[4], nl[4];
  nbrs(uh, k, S, nh);
  nbrs(um, k, S, nm);
  nbrs(ul, k, S, nl);
  r[k] = ts_resid(__ldg(b + k), __ldg(uh + k), nh, __ldg(um + k), nm,
                  __ldg(ul + k), nl);
}

dim3 grid_for(int S) {
  return dim3((S + kThreadsX - 1) / kThreadsX, (S + kThreadsY - 1) / kThreadsY);
}

// ---- 3D: the column march ----

constexpr int kCX = 64;  // block extent along x (two warps a row)
constexpr int kCY = 4;   // block extent along y
constexpr int kCZ = 8;   // planes a thread marches

// r = b - A(sum of the NC components) on the grid, masked to 1..n-1: NC = 2
// is the ds residual (u_hi, u_lo), NC = 3 the ts residual (u_hi, u_mid,
// u_lo).  Thread (x, y) of block bz owns the planes kCZ bz .. kCZ bz + kCZ-1.
template <int NC>
__global__ void __launch_bounds__(kCX * kCY)
    comp_residual3_kernel(const float* __restrict__ b,
                          const float* __restrict__ u0,
                          const float* __restrict__ u1,
                          const float* __restrict__ u2,
                          float* __restrict__ r, int Sz, int Sy, int Sx,
                          int n) {
  const int x = blockIdx.x * kCX + threadIdx.x;
  const int y = blockIdx.y * kCY + threadIdx.y;
  const int z0 = blockIdx.z * kCZ;
  if (x >= Sx || y >= Sy) return;
  const size_t plane = (size_t)Sy * Sx;
  const size_t k0 = ((size_t)z0 * Sy + y) * Sx + x;
  if (!(y >= 1 && y <= n - 1 && x >= 1 && x <= n - 1)) {
#pragma unroll
    for (int k = 0; k < kCZ; ++k)
      if (z0 + k < Sz) r[k0 + k * plane] = 0.0f;
    return;
  }
  const float* const comp[3] = {u0, u1, u2};
  // The column at z - 1 and z; cells past n read as zero (only masked
  // nodes could see them).
  float zm[NC], zc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    zm[c] = z0 >= 1 && z0 - 1 <= n ? __ldg(comp[c] + k0 - plane) : 0.0f;
    zc[c] = z0 <= n ? __ldg(comp[c] + k0) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kCZ; ++k) {
    const int z = z0 + k;
    if (z >= Sz) break;
    const size_t o = k0 + k * plane;
    float zp[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      zp[c] = z + 1 <= n ? __ldg(comp[c] + o + plane) : 0.0f;
    float out = 0.0f;
    if (z >= 1 && z <= n - 1) {
      float nb[NC][6];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        nb[c][0] = zm[c];
        nb[c][1] = zp[c];
        nb[c][2] = __ldg(comp[c] + o - Sx);
        nb[c][3] = __ldg(comp[c] + o + Sx);
        nb[c][4] = __ldg(comp[c] + o - 1);
        nb[c][5] = __ldg(comp[c] + o + 1);
      }
      const float bv = __ldg(b + o);
      if constexpr (NC == 2)
        out = ds_resid3(bv, zc[0], nb[0], zc[1], nb[1]);
      else
        out = ts_resid3(bv, zc[0], nb[0], zc[1], nb[1], zc[2], nb[2]);
    }
    r[o] = out;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      zm[c] = zc[c];
      zc[c] = zp[c];
    }
  }
}

template <int NC>
int launch_comp_residual3(const void* b, const void* u0, const void* u1,
                          const void* u2, void* r, int Sz, int Sy, int Sx,
                          int n, void* stream) {
  const dim3 grid((Sx + kCX - 1) / kCX, (Sy + kCY - 1) / kCY,
                  (Sz + kCZ - 1) / kCZ);
  comp_residual3_kernel<NC><<<grid, dim3(kCX, kCY), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<const float*>(u0),
      static_cast<const float*>(u1), static_cast<const float*>(u2),
      static_cast<float*>(r), Sz, Sy, Sx, n);
  return cudaGetLastError();
}

// ---- 3D flux stencil: the float64 residual (ds_residual_var3) ----
//
// r = fl32(b - A(u_hi + u_lo)) for the variable-coefficient 7-point flux
// stencil (VarStencilOp3D): (A u)_i = sum_f t_f (u_i - u_f) over the faces
// x+, x-, y+, y-, z+, z- from the float32 transmissibility planes tz, ty, tx
// (the minus faces are the planes one node back), plus c2_i u_i where the
// operator has a reaction plane, masked to 1..n-1 on every axis.
//
// It replaces no TPU kernel: the JAX package evaluates this residual in
// jnp.  It was added because the plain torch version (precision.py::
// ds_residual_var3_plain: about 25 ops over each of nine z-slabs of 2^24
// nodes, each writing a float64 temporary) took 20.2 ms a call at (528,
// 528, 640) on an H100, 41 % of the card's busy time in a refined 513^3
// variable-beta solve.
//
// What bounds it: device-memory traffic.  b, u_hi, u_lo and the planes tz,
// ty, tx read and r written: 7 passes of Sz*Sy*Sx*4 bytes, 4.99 GB at
// (528, 528, 640) (1.49 ms at 3.35 TB/s; 1.18 ms counting only the cells
// the interior reads, 0..n on every axis), 8 with the reaction plane.  The
// float64 work, some 30 operations and 18 conversions a node, stays under
// it.
//
// What the design does about it: comp_residual3_kernel's column march.  A
// block of 64 x 4 threads covers a (y, x) tile of kVZ planes, each thread
// one column; the thread keeps u = (double)u_hi + (double)u_lo at z - 1, z
// and z + 1 and tz at z - 1 in registers, so the z faces cost no load
// beyond the column's own; the x and y neighbours of u_hi and u_lo and the
// minus-face planes tx[x - 1] and ty[y - 1] come through L1 from the
// block's own rows; the blocks run z-major.  r is written once, coalesced,
// with the zeros of the masked nodes and the padding in the same pass.
// Cells outside 0..n on some axis are never read.  32 registers a thread,
// no spills: 8 blocks of 256 threads an SM.  At (528, 528, 640) it runs
// 1.68 ms, 89 % of the full-array bound (1.80-1.84 ms with the reaction
// plane); 4 and 16 planes a thread ran 1.77 / 1.74 ms, and the x
// neighbours exchanged by warp shuffles (fewer loads and conversions, the
// warp kept in lockstep) 1.64 ms, too little for its control flow.
//
// Arithmetic: the plain version's order, each step rounded on its own:
//   acc = tx(x) (c - u[x+1]); acc += tx(x-1) (c - u[x-1]); then y+, y-, z+,
//   z-; then acc += c2 c; r = fl32((double)b - acc)
// through __dadd_rn / __dsub_rn / __dmul_rn / __double2float_rn, which the
// compiler neither contracts nor reassociates: r equals the plain version's
// bit for bit.  Each neighbour's u_hi + u_lo is widened where it is read;
// the sum is the same float64 value wherever it is formed.

constexpr int kVZ = 8;  // planes a thread marches

// u_hi + u_lo at offset o, in float64.
__device__ __forceinline__ double wide(const float* __restrict__ uh,
                                       const float* __restrict__ ul,
                                       size_t o) {
  return __dadd_rn(static_cast<double>(__ldg(uh + o)),
                   static_cast<double>(__ldg(ul + o)));
}

// acc + t (c - v), each operation rounded on its own.
__device__ __forceinline__ double flux(double acc, float t, double c,
                                       double v) {
  return __dadd_rn(acc, __dmul_rn(static_cast<double>(t), __dsub_rn(c, v)));
}

// Thread (x, y) of block bz owns the planes kVZ bz .. kVZ bz + kVZ - 1;
// kC2: the operator has a reaction plane c2.
template <bool kC2>
__global__ void __launch_bounds__(kCX * kCY)
    ds_residual_var3_kernel(const float* __restrict__ b,
                            const float* __restrict__ uh,
                            const float* __restrict__ ul,
                            const float* __restrict__ tz,
                            const float* __restrict__ ty,
                            const float* __restrict__ tx,
                            const float* __restrict__ c2,
                            float* __restrict__ r, int Sz, int Sy, int Sx,
                            int n) {
  const int x = blockIdx.x * kCX + threadIdx.x;
  const int y = blockIdx.y * kCY + threadIdx.y;
  const int z0 = blockIdx.z * kVZ;
  if (x >= Sx || y >= Sy) return;
  const size_t plane = (size_t)Sy * Sx;
  const size_t k0 = ((size_t)z0 * Sy + y) * Sx + x;
  if (!(y >= 1 && y <= n - 1 && x >= 1 && x <= n - 1)) {
#pragma unroll
    for (int k = 0; k < kVZ; ++k)
      if (z0 + k < Sz) r[k0 + k * plane] = 0.0f;
    return;
  }
  // The column at z - 1 (u and the z- face's plane) and at z.
  const bool below = z0 >= 1 && z0 - 1 <= n;
  double um = below ? wide(uh, ul, k0 - plane) : 0.0;
  float tzm = below ? __ldg(tz + k0 - plane) : 0.0f;
  double uc = z0 <= n ? wide(uh, ul, k0) : 0.0;
#pragma unroll
  for (int k = 0; k < kVZ; ++k) {
    const int z = z0 + k;
    if (z >= Sz) break;
    const size_t o = k0 + k * plane;
    const double up = z + 1 <= n ? wide(uh, ul, o + plane) : 0.0;
    const float tzc = z <= n - 1 ? __ldg(tz + o) : 0.0f;
    float out = 0.0f;
    if (z >= 1 && z <= n - 1) {
      double acc = __dmul_rn(static_cast<double>(__ldg(tx + o)),
                             __dsub_rn(uc, wide(uh, ul, o + 1)));
      acc = flux(acc, __ldg(tx + o - 1), uc, wide(uh, ul, o - 1));
      acc = flux(acc, __ldg(ty + o), uc, wide(uh, ul, o + Sx));
      acc = flux(acc, __ldg(ty + o - Sx), uc, wide(uh, ul, o - Sx));
      acc = flux(acc, tzc, uc, up);
      acc = flux(acc, tzm, uc, um);
      if constexpr (kC2)
        acc = __dadd_rn(acc, __dmul_rn(static_cast<double>(__ldg(c2 + o)),
                                       uc));
      out = __double2float_rn(
          __dsub_rn(static_cast<double>(__ldg(b + o)), acc));
    }
    r[o] = out;
    um = uc;
    uc = up;
    tzm = tzc;
  }
}

template <bool kC2>
int launch_ds_residual_var3(const void* b, const void* uh, const void* ul,
                            const void* tz, const void* ty, const void* tx,
                            const void* c2, void* r, int Sz, int Sy, int Sx,
                            int n, void* stream) {
  const dim3 grid((Sx + kCX - 1) / kCX, (Sy + kCY - 1) / kCY,
                  (Sz + kVZ - 1) / kVZ);
  ds_residual_var3_kernel<kC2><<<grid, dim3(kCX, kCY), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<const float*>(uh),
      static_cast<const float*>(ul), static_cast<const float*>(tz),
      static_cast<const float*>(ty), static_cast<const float*>(tx),
      static_cast<const float*>(c2), static_cast<float*>(r), Sz, Sy, Sx, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tmt_ds_residual(const void* b, const void* uh, const void* ul, void* r,
                    int S, int n, void* stream) {
  ds_residual_kernel<<<grid_for(S), dim3(kThreadsX, kThreadsY), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<const float*>(uh),
      static_cast<const float*>(ul), static_cast<float*>(r), S, n);
  return cudaGetLastError();
}

int tmt_ts_residual(const void* b, const void* uh, const void* um,
                    const void* ul, void* r, int S, int n, void* stream) {
  ts_residual_kernel<<<grid_for(S), dim3(kThreadsX, kThreadsY), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<const float*>(uh),
      static_cast<const float*>(um), static_cast<const float*>(ul),
      static_cast<float*>(r), S, n);
  return cudaGetLastError();
}

// The 3D entries: contiguous (Sz, Sy, Sx) float32 arrays, 1 <= n <=
// min(Sz, Sy, Sx) - 1 (the wrapper checks both).
int tmt_ds_residual3(const void* b, const void* uh, const void* ul, void* r,
                     int Sz, int Sy, int Sx, int n, void* stream) {
  return launch_comp_residual3<2>(b, uh, ul, ul, r, Sz, Sy, Sx, n, stream);
}

int tmt_ts_residual3(const void* b, const void* uh, const void* um,
                     const void* ul, void* r, int Sz, int Sy, int Sx, int n,
                     void* stream) {
  return launch_comp_residual3<3>(b, uh, um, ul, r, Sz, Sy, Sx, n, stream);
}

// The flux stencil's float64 residual: contiguous (Sz, Sy, Sx) float32
// arrays b, u_hi, u_lo and planes tz, ty, tx, c2 (null: no reaction plane),
// 1 <= n <= min(Sz, Sy, Sx) - 1 (the wrapper checks both).
int tmt_ds_residual_var3(const void* b, const void* uh, const void* ul,
                         const void* tz, const void* ty, const void* tx,
                         const void* c2, void* r, int Sz, int Sy, int Sx,
                         int n, void* stream) {
  if (c2 != nullptr)
    return launch_ds_residual_var3<true>(b, uh, ul, tz, ty, tx, c2, r, Sz,
                                         Sy, Sx, n, stream);
  return launch_ds_residual_var3<false>(b, uh, ul, tz, ty, tx, c2, r, Sz, Sy,
                                        Sx, n, stream);
}

}  // extern "C"
