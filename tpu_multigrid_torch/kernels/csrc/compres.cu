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
// tpu_multigrid_torch/precision.py::_ds_cascade / _ts_cascade: r agrees with
// the plain torch version bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// Neighbour sum with Neumaier compensation, terms in the plain version's
// order (i-1, i+1, j-1, j+1): s + c is the exact sum.
__device__ __forceinline__ void nbr_comp(const float* __restrict__ x,
                                         size_t k, int S, float& s,
                                         float& c) {
  float e;
  s = __ldg(x + k - S);
  c = 0.0f;
  two_sum(s, __ldg(x + k + S), s, e);
  c = __fadd_rn(c, e);
  two_sum(s, __ldg(x + k - 1), s, e);
  c = __fadd_rn(c, e);
  two_sum(s, __ldg(x + k + 1), s, e);
  c = __fadd_rn(c, e);
}

__device__ __forceinline__ float nbr(const float* __restrict__ x, size_t k,
                                     int S) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__ldg(x + k - S), __ldg(x + k + S)),
                             __ldg(x + k - 1)),
                   __ldg(x + k + 1));
}

// A(x) = 4x - nbr(x) in plain f32: the smallest component's term.
__device__ __forceinline__ float apply_a(const float* __restrict__ x,
                                         size_t k, int S) {
  return __fsub_rn(__fmul_rn(4.0f, __ldg(x + k)), nbr(x, k, S));
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
  float nbr_h, c_h, s, e1, e2, c1, c2, c3, c4;
  nbr_comp(uh, k, S, nbr_h, c_h);
  two_sum(__ldg(b + k), nbr_h, s, e1);
  two_sum(s, __fmul_rn(-4.0f, __ldg(uh + k)), s, e2);
  const float a_lo = apply_a(ul, k, S);
  two_sum(s, e1, s, c1);
  two_sum(s, e2, s, c2);
  two_sum(s, c_h, s, c3);
  two_sum(s, -a_lo, s, c4);
  r[k] = __fadd_rn(s, __fadd_rn(c1, __fadd_rn(c2, __fadd_rn(c3, c4))));
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
  float nbr_h, c_h, nbr_m, c_m, s, e1, e2, e3, e4;
  float c1, c2, c3, c4, c5, c6, c7;
  nbr_comp(uh, k, S, nbr_h, c_h);
  nbr_comp(um, k, S, nbr_m, c_m);
  two_sum(__ldg(b + k), nbr_h, s, e1);
  two_sum(s, __fmul_rn(-4.0f, __ldg(uh + k)), s, e2);
  two_sum(s, nbr_m, s, e3);
  two_sum(s, __fmul_rn(-4.0f, __ldg(um + k)), s, e4);
  const float a_l = apply_a(ul, k, S);
  two_sum(s, e1, s, c1);
  two_sum(s, e2, s, c2);
  two_sum(s, e3, s, c3);
  two_sum(s, e4, s, c4);
  two_sum(s, c_h, s, c5);
  two_sum(s, c_m, s, c6);
  two_sum(s, -a_l, s, c7);
  const float tail = __fadd_rn(
      c1, __fadd_rn(c2, __fadd_rn(c3, __fadd_rn(c4, __fadd_rn(
                                              c5, __fadd_rn(c6, c7))))));
  r[k] = __fadd_rn(s, tail);
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
