// The compensated-refinement kernels on ghost-extended blocks, for Hopper
// (sm_90a): the ds / ts residual and the exact-pair prolongation of the
// distributed refinement (dist/refine_pallas.py), and the compensated add
// of every refinement loop on the card (precision._accumulate as well).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/localref.py::
// _comp_residual_local, ::_prolong_pair_local and ::_comp_add_local.
//
// The blocks are kernels/local.py's: an (R, C) = (lr + 2*GR, lc + 2*GC)
// array whose cell (i, j) has the global coordinates (o0 + i, o1 + j), live
// where those lie in 1..n-1; the coarse block is (R/2 + GR, C/2 + GC).
//
//   comp_residual: r = b - A(u_hi + u_lo) (ds) or b - A(u_hi + u_mid + u_lo)
//       (ts) at the live cells, 0 elsewhere, to ~eps^2 / ~eps^3.
//   prolong_pair: (p_hi, p_lo) with p_hi + p_lo == P ec_hi + P ec_lo exactly
//       up to one rounding of p_lo: the exact pair of P ec_hi (hi + err, as
//       transfer.cu's prolong_comp takes it), then p_lo = P ec_lo + err; both
//       zero outside the live cells of the fine level nf.
//   comp_add: the ds pair (k = 2) or ts triple (k = 3) += each of m = 1 or 2
//       plain arrays in turn, through precision.ds_add / ts_add's TwoSum
//       cascades, renormalised after each, in place.
//
// Every output is defined on the whole array, as in the plain versions:
// cells outside the array read as zero.  (The TPU kernels leave the ghost
// ring undefined; the two agree on the owned region.)
//
// What bounds them: device-memory traffic.  comp_residual reads b and the 2
// or 3 components and writes r (4 or 5 passes of R*C*4 bytes) against
// ~64 / 115 flops per cell; prolong_pair reads the two quarter-size coarse
// blocks and writes two fine ones (2.5 passes); comp_add reads k + m arrays
// and writes k (5 to 8 passes) against ~10-20 flops per cell and added
// array.
//
// What the design does about it: one thread per cell, reading its cell and
// neighbours straight from device memory (adjacent threads share them
// through L1/L2), with the whole cascade in registers, so each input is read
// from device memory about once and each output written once.  comp_add
// writes its results over its inputs, so the ts triple of a 16385^2 block
// needs no second copy.
// One 4-byte load and store a thread a step, under a grid-stride loop, moves
// 79-84 % of an H100's peak bytes for a ds pair plus one addend at the
// refinement cells' grids: no wider access is needed to near the bound.
//
// Arithmetic: TwoSum is exact IEEE arithmetic, so every operation goes
// through __fadd_rn/__fsub_rn/__fmul_rn (twosum.cuh, compsum.cuh) or plain
// operators under -fmad=false, in the plain versions' order: every output
// agrees with the plain torch versions bitwise.

#include "compsum.cuh"
#include "ext.cuh"

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kAddThreads = 256;

struct Block {
  int R;
  int C;
  int o0;
  int o1;
  int n;
  __device__ __forceinline__ bool live(int i, int j) const {
    const int gi = o0 + i;
    const int gj = o1 + j;
    return gi >= 1 && gi <= n - 1 && gj >= 1 && gj <= n - 1;
  }
};

// x at (i, j) and its four neighbours (up, down, left, right); cells outside
// the array read 0.
__device__ __forceinline__ float fetch(const float* __restrict__ x,
                                       const Block& g, int i, int j,
                                       float nb[4]) {
  const size_t k = (size_t)i * g.C + j;
  nb[0] = i > 0 ? __ldg(x + k - g.C) : 0.0f;
  nb[1] = i < g.R - 1 ? __ldg(x + k + g.C) : 0.0f;
  nb[2] = j > 0 ? __ldg(x + k - 1) : 0.0f;
  nb[3] = j < g.C - 1 ? __ldg(x + k + 1) : 0.0f;
  return __ldg(x + k);
}

// um == nullptr: the ds residual of (uh, ul).
__global__ void comp_residual_ext_kernel(const float* __restrict__ b,
                                         const float* __restrict__ uh,
                                         const float* __restrict__ um,
                                         const float* __restrict__ ul,
                                         float* __restrict__ r, Block g) {
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.R || j >= g.C) return;
  const size_t k = (size_t)i * g.C + j;
  if (!g.live(i, j)) {
    r[k] = 0.0f;
    return;
  }
  float nh[4], nm[4], nl[4];
  const float vh = fetch(uh, g, i, j, nh);
  const float vl = fetch(ul, g, i, j, nl);
  if (um == nullptr) {
    r[k] = ds_resid(__ldg(b + k), vh, nh, vl, nl);
  } else {
    const float vm = fetch(um, g, i, j, nm);
    r[k] = ts_resid(__ldg(b + k), vh, nh, vm, nm, vl, nl);
  }
}

// Fine (R, C) from coarse (R/2 + GR, C/2 + GC); g.n is the fine level's n.
__global__ void prolong_pair_ext_kernel(const float* __restrict__ ec_hi,
                                        const float* __restrict__ ec_lo,
                                        float* __restrict__ p_hi,
                                        float* __restrict__ p_lo, Block g) {
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.R || j >= g.C) return;
  const size_t k = (size_t)i * g.C + j;
  if (!g.live(i, j)) {
    p_hi[k] = 0.0f;
    p_lo[k] = 0.0f;
    return;
  }
  const int Cc = g.C / 2 + kGC;
  const int I = (i >> 1) + kGR / 2;
  const int J = (j >> 1) + kGC / 2;
  auto c = [&](int a, int bb) { return __ldg(ec_hi + (size_t)a * Cc + bb); };
  const bool odd_i = i & 1;
  const bool odd_j = j & 1;
  float h, e = 0.0f, s, t;
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
  p_hi[k] = h;
  p_lo[k] = __fadd_rn(prolong_ext(ec_lo, Cc, i, j), e);
}

// precision._quick_two_sum: s + e == a + b exactly when |a| >= |b|.
__device__ __forceinline__ void quick_two_sum(float a, float b, float& s,
                                              float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

// precision.ds_add: (hi + lo) + y.
__device__ __forceinline__ void ds_add(float& hi, float& lo, float y) {
  float s, e;
  two_sum(hi, y, s, e);
  quick_two_sum(s, __fadd_rn(lo, e), hi, lo);
}

// precision.ts_add: (hi + mid + lo) + y, renormalised (_ts_renorm).
__device__ __forceinline__ void ts_add(float& hi, float& mid, float& lo,
                                       float y) {
  float s1, e1, s2, e2, s, t, t2;
  two_sum(hi, y, s1, e1);
  two_sum(mid, e1, s2, e2);
  const float s3 = __fadd_rn(lo, e2);
  two_sum(s2, s3, s, t);
  two_sum(s1, s, hi, t2);
  quick_two_sum(t2, t, mid, lo);
}

template <int K, int M>
__global__ void __launch_bounds__(kAddThreads)
comp_add_ext_kernel(float* __restrict__ c0, float* __restrict__ c1,
                    float* __restrict__ c2, const float* __restrict__ y0,
                    const float* __restrict__ y1, long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < count; k += stride) {
    float a = c0[k];
    float b = c1[k];
    float c = K == 3 ? c2[k] : 0.0f;
    for (int m = 0; m < M; ++m) {
      const float y = __ldg((m == 0 ? y0 : y1) + k);
      if (K == 2) {
        ds_add(a, b, y);
      } else {
        ts_add(a, b, c, y);
      }
    }
    c0[k] = a;
    c1[k] = b;
    if (K == 3) c2[k] = c;
  }
}

dim3 cell_grid(int R, int C) {
  return dim3((C + kThreadsX - 1) / kThreadsX,
              (R + kThreadsY - 1) / kThreadsY);
}

}  // namespace

extern "C" {

// b, u_hi, u_lo, r: (R, C); u_mid null for the ds residual.
int tmt_comp_residual_ext(const void* b, const void* uh, const void* um,
                          const void* ul, void* r, int R, int C, int o0,
                          int o1, int n, void* stream) {
  comp_residual_ext_kernel<<<cell_grid(R, C), dim3(kThreadsX, kThreadsY), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<const float*>(uh),
      static_cast<const float*>(um), static_cast<const float*>(ul),
      static_cast<float*>(r), Block{R, C, o0, o1, n});
  return cudaGetLastError();
}

// ec_hi, ec_lo: (R/2 + GR, C/2 + GC); p_hi, p_lo: (R, C); nf the fine n.
int tmt_prolong_pair_ext(const void* ec_hi, const void* ec_lo, void* p_hi,
                         void* p_lo, int R, int C, int o0, int o1, int nf,
                         void* stream) {
  if (R % 2 || C % 2) return cudaErrorInvalidValue;
  prolong_pair_ext_kernel<<<cell_grid(R, C), dim3(kThreadsX, kThreadsY), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ec_hi), static_cast<const float*>(ec_lo),
      static_cast<float*>(p_hi), static_cast<float*>(p_lo),
      Block{R, C, o0, o1, nf});
  return cudaGetLastError();
}

// c0, c1 (and c2 for a triple) += y0 (then y1 when not null), in place;
// `count` elements each.
int tmt_comp_add_ext(void* c0, void* c1, void* c2, const void* y0,
                     const void* y1, long long count, void* stream) {
  if (count <= 0) return cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long need = (count + kAddThreads - 1) / kAddThreads;
  const unsigned blocks =
      static_cast<unsigned>(need < 32LL * sms ? need : 32LL * sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(c0);
  float* b = static_cast<float*>(c1);
  float* c = static_cast<float*>(c2);
  const float* x = static_cast<const float*>(y0);
  const float* y = static_cast<const float*>(y1);
  if (c == nullptr && y == nullptr) {
    comp_add_ext_kernel<2, 1><<<blocks, kAddThreads, 0, st>>>(a, b, c, x, y,
                                                               count);
  } else if (c == nullptr) {
    comp_add_ext_kernel<2, 2><<<blocks, kAddThreads, 0, st>>>(a, b, c, x, y,
                                                               count);
  } else if (y == nullptr) {
    comp_add_ext_kernel<3, 1><<<blocks, kAddThreads, 0, st>>>(a, b, c, x, y,
                                                               count);
  } else {
    comp_add_ext_kernel<3, 2><<<blocks, kAddThreads, 0, st>>>(a, b, c, x, y,
                                                               count);
  }
  return cudaGetLastError();
}

}  // extern "C"
