// Compensated residuals of a double-single or triple-single iterate, for
// Hopper (sm_90a).
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

}  // extern "C"
