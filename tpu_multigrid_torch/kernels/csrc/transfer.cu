// K1 (smooth_restrict) and K2 (prolong_smooth, prolong_smooth_resnorm):
// the two kernels of a multigrid level visit, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/transfer.py::
// _smooth_restrict (K1) and ::_prolong_smooth (K2).
//
//   K1: `steps` Jacobi (per-step weights) or red-black Gauss-Seidel steps
//       on u, then r = b - A u, then full-weighting restriction of r to the
//       coarse grid, masked to the coarse interior.  Writes u' and rc.
//   K2: u <- mask(u + P ec) with bilinear P, then `steps` smoothing steps.
//       Writes u'; the resnorm variant also writes one partial sum of
//       (b - A u')^2 per block, which a second one-block kernel adds up.
//
// What bounds them: device-memory traffic.  K1 reads u and b and writes u'
// and the quarter-size rc; K2 reads u, b and the quarter-size ec and writes
// u': about 3.3 passes of S*S*4 bytes each, against 8*steps + 16 flops per
// node, far below the card's flop-per-byte balance.  Run unfused, every
// sweep, the residual and each transfer would be passes of their own.
//
// What the design does about it: one block per 64x64 fine output tile, at an
// even origin so that its coarse tile is aligned too.  The block loads the
// tile plus a halo into shared memory once (steps + 2 rings for K1: each step
// invalidates one ring, the residual and the restriction need two more;
// steps + 1 for K2, whose resnorm needs one), runs every step there and
// writes only the outputs, so the sweeps cost no device-memory passes
// (ghost-zone temporal blocking).  Neighbouring blocks reload each other's
// halos, mostly from L2.
//
// Arithmetic: the same operations in the same order as the plain torch
// versions (tpu_multigrid_torch/core/ops.py), built with -fmad=false so that
// nothing is contracted into an FMA: u' and rc match the plain versions
// bitwise.  The resnorm partials are summed in a fixed tree order with no
// atomics, so the norm, and every until-tol decision made from it, repeats
// run to run.  Cells outside the array read as zero; the interior mask is
// taken from global indices, as in the plain versions.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // fine output tile side (even)
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMaxWeights = 16;
constexpr int kMaxSmemBytes = 227 * 1024;

// Per-step Jacobi weights, rounded to f32 on the host exactly as the plain
// version rounds them: c1 = 1 - w, c2 = w / 4.  Step s uses entry s % count.
struct Weights {
  float c1[kMaxWeights];
  float c2[kMaxWeights];
  int count;
};

__device__ __forceinline__ bool is_interior(int i, int j, int n) {
  return i >= 1 && i <= n - 1 && j >= 1 && j <= n - 1;
}

// u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1], in the plain version's order.
__device__ __forceinline__ float nbr(const float* v, int k, int w) {
  return ((v[k - w] + v[k + w]) + v[k - 1]) + v[k + 1];
}

// The (w x w) window at global origin (r0, c0); cells outside the array
// read 0.
__device__ void load_window(float* dst, const float* __restrict__ src,
                            int S, int r0, int c0, int w) {
  for (int li = threadIdx.y; li < w; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
      const int gj = c0 + lj;
      dst[li * w + lj] = (gi >= 0 && gi < S && gj >= 0 && gj < S)
                             ? src[(size_t)gi * S + gj]
                             : 0.0f;
    }
  }
}

// Runs the smoothing steps on the window; returns the buffer that holds the
// result (the other one is free).  The outermost ring has no neighbours and
// keeps its value: it is invalid after the first step, and the halo is deep
// enough that invalid cells never reach an output.
__device__ float* smooth_window(float* v, float* spare, const float* bw,
                                int w, int r0, int c0, int n, int steps,
                                int rbgs, const Weights& wt) {
  for (int s = 0; s < steps; ++s) {
    if (rbgs) {
      // Half-step s updates colour s % 2 in place; same-colour nodes do not
      // couple, so no thread reads a node another thread writes.
      const int color = s & 1;
      for (int li = threadIdx.y + 1; li < w - 1; li += blockDim.y) {
        const int gi = r0 + li;
        for (int lj = threadIdx.x + 1; lj < w - 1; lj += blockDim.x) {
          const int gj = c0 + lj;
          const int k = li * w + lj;
          if (is_interior(gi, gj, n) && ((gi + gj) & 1) == color) {
            v[k] = 0.25f * (bw[k] + nbr(v, k, w));
          }
        }
      }
    } else {
      const float c1 = wt.c1[s % wt.count];
      const float c2 = wt.c2[s % wt.count];
      for (int li = threadIdx.y; li < w; li += blockDim.y) {
        const int gi = r0 + li;
        for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
          const int gj = c0 + lj;
          const int k = li * w + lj;
          float out = v[k];
          if (li > 0 && li < w - 1 && lj > 0 && lj < w - 1) {
            out = is_interior(gi, gj, n)
                      ? c1 * v[k] + c2 * (bw[k] + nbr(v, k, w))
                      : 0.0f;
          }
          spare[k] = out;
        }
      }
      float* t = v;
      v = spare;
      spare = t;
    }
    __syncthreads();
  }
  return v;
}

// The [1/2, 1, 1/2] blur along a row, at window index k.
__device__ __forceinline__ float row_blur(const float* r, int k) {
  return r[k] + 0.5f * (r[k - 1] + r[k + 1]);
}

// Bilinear prolongation of ec at fine node (gi, gj) >= 0; coarse nodes at or
// past m read 0 (the plain version's crop).
__device__ __forceinline__ float prolong_at(const float* __restrict__ ec,
                                            int Sc, int m, int gi, int gj) {
  const int I = gi >> 1;
  const int J = gj >> 1;
  auto c = [&](int a, int bb) {
    return (a < m && bb < m) ? __ldg(ec + (size_t)a * Sc + bb) : 0.0f;
  };
  const bool odd_i = gi & 1;
  const bool odd_j = gj & 1;
  if (!odd_i && !odd_j) return c(I, J);
  if (odd_i && !odd_j) return 0.5f * (c(I, J) + c(I + 1, J));
  if (!odd_i && odd_j) return 0.5f * (c(I, J) + c(I, J + 1));
  return 0.25f * (((c(I, J) + c(I, J + 1)) + c(I + 1, J)) + c(I + 1, J + 1));
}

__device__ float block_sum(float acc, float* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  red[tid] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

__global__ void __launch_bounds__(kThreads)
smooth_restrict_kernel(const float* __restrict__ u,
                       const float* __restrict__ b,
                       float* __restrict__ u_out, float* __restrict__ rc,
                       int S, int Sc, int n, int steps, int rbgs,
                       Weights wt) {
  extern __shared__ float smem[];
  const int halo = steps + 2;
  const int w = kTile + 2 * halo;
  const int ro = blockIdx.y * kTile;
  const int co = blockIdx.x * kTile;
  const int cr0 = ro / 2;
  const int cc0 = co / 2;
  const int ct = kTile / 2;
  const int nc = n / 2;

  if (ro >= S || co >= S) {
    // Coarse tail past S/2: no fine tile maps here; it stays zero.
    for (int ci = threadIdx.y; ci < ct; ci += blockDim.y) {
      for (int cj = threadIdx.x; cj < ct; cj += blockDim.x) {
        const int I = cr0 + ci;
        const int J = cc0 + cj;
        if (I < Sc && J < Sc) rc[(size_t)I * Sc + J] = 0.0f;
      }
    }
    return;
  }

  float* buf_a = smem;
  float* buf_b = smem + w * w;
  float* bw = smem + 2 * w * w;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  load_window(buf_a, u, S, r0, c0, w);
  load_window(bw, b, S, r0, c0, w);
  __syncthreads();

  float* v = smooth_window(buf_a, buf_b, bw, w, r0, c0, n, steps, rbgs, wt);
  float* r = (v == buf_a) ? buf_b : buf_a;

  for (int ti = threadIdx.y; ti < kTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (gi < S && gj < S) {
        u_out[(size_t)gi * S + gj] = v[(ti + halo) * w + tj + halo];
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
      r[k] = is_interior(gi, gj, n) ? (bw[k] - 4.0f * v[k]) + nbr(v, k, w)
                                    : 0.0f;
    }
  }
  __syncthreads();

  // Full weighting at the tile's even nodes: blur along rows, then columns.
  for (int ci = threadIdx.y; ci < ct; ci += blockDim.y) {
    const int I = cr0 + ci;
    for (int cj = threadIdx.x; cj < ct; cj += blockDim.x) {
      const int J = cc0 + cj;
      if (I >= Sc || J >= Sc) continue;
      float val = 0.0f;
      if (I >= 1 && I <= nc - 1 && J >= 1 && J <= nc - 1) {
        const int k = (2 * ci + halo) * w + 2 * cj + halo;
        val = row_blur(r, k) + 0.5f * (row_blur(r, k - w) + row_blur(r, k + w));
      }
      rc[(size_t)I * Sc + J] = val;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
prolong_smooth_kernel(const float* __restrict__ u,
                      const float* __restrict__ b,
                      const float* __restrict__ ec,
                      float* __restrict__ u_out,
                      float* __restrict__ partials,
                      int S, int Sc, int n, int steps, int rbgs,
                      Weights wt) {
  extern __shared__ float smem[];
  const int halo = steps + 1;
  const int w = kTile + 2 * halo;
  const int ro = blockIdx.y * kTile;
  const int co = blockIdx.x * kTile;
  const int r0 = ro - halo;
  const int c0 = co - halo;
  const int m = min(Sc, (S + 1) / 2);
  float* buf_a = smem;
  float* buf_b = smem + w * w;
  float* bw = smem + 2 * w * w;

  for (int li = threadIdx.y; li < w; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
      const int gj = c0 + lj;
      const int k = li * w + lj;
      const bool in_array = gi >= 0 && gi < S && gj >= 0 && gj < S;
      buf_a[k] = is_interior(gi, gj, n)
                     ? u[(size_t)gi * S + gj] + prolong_at(ec, Sc, m, gi, gj)
                     : 0.0f;
      bw[k] = in_array ? b[(size_t)gi * S + gj] : 0.0f;
    }
  }
  __syncthreads();

  float* v = smooth_window(buf_a, buf_b, bw, w, r0, c0, n, steps, rbgs, wt);

  float acc = 0.0f;
  for (int ti = threadIdx.y; ti < kTile; ti += blockDim.y) {
    const int gi = ro + ti;
    for (int tj = threadIdx.x; tj < kTile; tj += blockDim.x) {
      const int gj = co + tj;
      if (gi >= S || gj >= S) continue;
      const int k = (ti + halo) * w + tj + halo;
      u_out[(size_t)gi * S + gj] = v[k];
      if (partials != nullptr && is_interior(gi, gj, n)) {
        const float rr = (bw[k] - 4.0f * v[k]) + nbr(v, k, w);
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

// One block adds the partials in a fixed order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int count,
                    float* __restrict__ out) {
  __shared__ float red[kThreads];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  for (int i = tid; i < count; i += kThreads) acc += partials[i];
  const float total = block_sum(acc, red);
  if (tid == 0) out[0] = total;
}

int window_bytes(int halo) {
  const int w = kTile + 2 * halo;
  return 3 * w * w * static_cast<int>(sizeof(float));
}

cudaError_t make_weights(const float* host, int count, Weights* wt) {
  if (count < 1 || count > kMaxWeights) return cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    wt->c1[i] = host[i];
    wt->c2[i] = host[count + i];
  }
  for (int i = count; i < kMaxWeights; ++i) {
    wt->c1[i] = 0.0f;
    wt->c2[i] = 0.0f;
  }
  wt->count = count;
  return cudaSuccess;
}

constexpr int kDefaultSmemBytes = 48 * 1024;
constexpr int kMaxDevices = 64;

// Opts `kernel` in to `bytes` of dynamic shared memory on the current
// device.  The attribute holds per device, so `configured[device]` keeps the
// largest opt-in made there (0 until the first one); devices past
// kMaxDevices set it at every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* configured) {
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (bytes <= kDefaultSmemBytes) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && bytes <= configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (cached) configured[device] = bytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int tmt_transfer_tile(void) { return kTile; }

// Largest `steps` whose window fits in shared memory (K1's halo is deeper).
int tmt_transfer_max_steps(void) {
  int steps = 0;
  while (window_bytes(steps + 3) <= kMaxSmemBytes) ++steps;
  return steps;
}

const char* tmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// weights: host array [c1[0..count), c2[0..count)], ignored for RB-GS.
// Grid covers 2*Sc (>= S) so that the coarse tail past S/2 is zeroed too.
int tmt_smooth_restrict(const void* u, const void* b, void* u_out, void* rc,
                        int S, int Sc, int n, int steps, int rbgs,
                        const void* weights, int count, void* stream) {
  static int configured[kMaxDevices] = {};
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const int bytes = window_bytes(steps + 2);
  err = allow_smem(smooth_restrict_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (2 * Sc + kTile - 1) / kTile;
  smooth_restrict_kernel<<<dim3(tiles, tiles), dim3(kThreadsX, kThreadsY),
                           bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<float*>(u_out), static_cast<float*>(rc), S, Sc, n, steps,
      rbgs, wt);
  return cudaGetLastError();
}

// partials: (S/kTile rounded up)^2 floats, or null for no resnorm; then
// out_sum[0] receives the sum of (b - A u')^2 over the interior.
int tmt_prolong_smooth(const void* u, const void* b, const void* ec,
                       void* u_out, void* partials, void* out_sum, int S,
                       int Sc, int n, int steps, int rbgs,
                       const void* weights, int count, void* stream) {
  static int configured[kMaxDevices] = {};
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const int bytes = window_bytes(steps + 1);
  err = allow_smem(prolong_smooth_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTile - 1) / kTile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  prolong_smooth_kernel<<<dim3(tiles, tiles), dim3(kThreadsX, kThreadsY),
                          bytes, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<const float*>(ec), static_cast<float*>(u_out),
      static_cast<float*>(partials), S, Sc, n, steps, rbgs, wt);
  err = cudaGetLastError();
  if (err != cudaSuccess || partials == nullptr) return err;
  sum_partials_kernel<<<1, dim3(kThreadsX, kThreadsY), 0, st>>>(
      static_cast<const float*>(partials), tiles * tiles,
      static_cast<float*>(out_sum));
  return cudaGetLastError();
}

}  // extern "C"
