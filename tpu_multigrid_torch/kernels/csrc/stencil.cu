// The streaming smoother: `steps` Jacobi (per-step weights) or red-black
// Gauss-Seidel steps of the 5-point Poisson stencil, optionally followed by
// the residual r = b - A u', in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_multigrid/kernels/stencil.py::_streamed
// (entries jacobi_sweeps, jacobi_sweeps_residual, rbgs_sweeps,
// rbgs_sweeps_residual and residual).
//
// What bounds it: device-memory traffic.  It reads u and b and writes u'
// (and r): 3 or 4 passes of S*S*4 bytes, against 8*steps + 6 flops per node.
// A tiled window (ghost zones around a 64x64 tile, every step over the
// whole window) moved those bytes at 12-30 % of the memory rate: three
// blocks per SM, idle lanes on the window's ragged columns, and a barrier
// per step left it latency-bound.
//
// What the design does about it: a row march (2.5D blocking in one
// dimension less).  Each warp owns a 128-column window (32 lanes x 4
// adjacent columns) around a strip of 128 - 2 hx output columns (hx = the
// halo rounded up to 4) and marches down a segment of kRowSegment rows.
// The steps form a wavefront: at row p, step s updates row p - s from step
// s - 1's rows p - s - 1, p - s and p - s + 1, which the lane holds in
// registers; the x neighbours of its outer columns come from the lanes
// beside it by shuffle.  The residual is one more stage, so every node is
// updated once per step and u' (and r) are written once.  u and b rows
// arrive by cp.async into a per-warp ring kRowPrefetch rows ahead of the
// wavefront.  A warp never waits for another (no block barrier), a segment
// starts with a fill of `halo` rows, and the step count is a template
// parameter so that the stages' registers and per-step weights are
// indexed statically.  A launch takes at most kMaxSteps steps; the wrapper
// splits deeper smoothing into several launches, passing each the global
// index of its first step so that the RB-GS colours carry on, and fuses the
// residual into the last one only.
//
// Arithmetic: the same operations in the same order as core/ops.py's
// jacobi_sweeps, redblack_gs_sweeps and residual, built with -fmad=false:
// u' and r match the plain versions bitwise.  The march changes when a node
// is computed, never how.

#include "cpasync.cuh"
#include "window.cuh"

namespace {

constexpr int kMaxSteps = 16;         // steps per launch
constexpr int kRowCols = 4;           // adjacent columns per lane
constexpr int kRowWidth = 32 * kRowCols;   // a warp's window: 128 columns
constexpr int kRowWarps = 4;          // independent warps per block
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowSegment = 128;      // output rows per warp
constexpr int kRowPrefetch = 2;       // rows in flight ahead of the march

// Jacobi weights per local step of a launch, expanded on the host (c1 = 1 -
// w, c2 = w / 4), so that the unrolled steps read them at fixed offsets.
struct StepWeights {
  float c1[kMaxSteps];
  float c2[kMaxSteps];
};

__device__ __forceinline__ float lane_col(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// One warp-row of 4 values per lane into the array (row r, first column
// xl); columns past S are not written.
__device__ __forceinline__ void store_row(float* __restrict__ dst, int S,
                                          int r, int xl, const float* v,
                                          bool aligned) {
  const size_t o = static_cast<size_t>(r) * S + xl;
  if (aligned) {
    if (xl < S) *reinterpret_cast<float4*>(dst + o) =
        make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < kRowCols; ++c) {
    if (xl + c < S) dst[o + c] = v[c];
  }
}

template <int STEPS>
__global__ void __launch_bounds__(kRowThreads)
row_march_kernel(const float* __restrict__ u, const float* __restrict__ b,
                 float* __restrict__ u_out, float* __restrict__ r_out, int S,
                 int n, int first_step, int rbgs, int aligned,
                 StepWeights wt) {
  constexpr int Ru = kRowPrefetch + 2;          // rows p .. p + prefetch
  constexpr int Rb = STEPS + kRowPrefetch + 3;  // rows p - STEPS - 1 .. on
  extern __shared__ float4 rings[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* ring_u = rings + warp * (Ru + Rb) * 32 + lane;
  float4* ring_b = ring_u + Ru * 32;
  const bool want_r = r_out != nullptr;
  const int halo = STEPS + (want_r ? 1 : 0);
  const int hx = (halo + kRowCols - 1) & ~(kRowCols - 1);
  const int T = kRowWidth - 2 * hx;             // output columns per warp
  const int strips = (S + T - 1) / T;
  const int segs = (S + kRowSegment - 1) / kRowSegment;
  const int id = blockIdx.x * kRowWarps + warp;
  if (id >= strips * segs) return;              // the whole warp
  const int R0 = (id / strips) * kRowSegment;
  const int R1 = min(R0 + kRowSegment, S);
  const int xl = (id % strips) * T - hx + kRowCols * lane;
  const bool out_lane = kRowCols * lane >= hx && kRowCols * lane < hx + T;
  bool col_in[kRowCols];
#pragma unroll
  for (int c = 0; c < kRowCols; ++c) {
    col_in[c] = xl + c >= 1 && xl + c <= n - 1;
  }

  // Row r into ring slot i: 16-byte copies when the rows are aligned, else
  // one per column; cells outside the array fill 0.
  auto issue = [&](int r, int i) {
    const bool row_ok = r >= 0 && r < S;
    const size_t base = static_cast<size_t>(row_ok ? r : 0) * S;
    float* du = reinterpret_cast<float*>(ring_u + (i % Ru) * 32);
    float* db = reinterpret_cast<float*>(ring_b + (i % Rb) * 32);
    if (aligned) {
      const bool ok = row_ok && xl >= 0 && xl < S;
      const size_t o = ok ? base + xl : 0;
      cp_async16(du, u + o, ok);
      cp_async16(db, b + o, ok);
    } else {
#pragma unroll
      for (int c = 0; c < kRowCols; ++c) {
        const bool ok = row_ok && xl + c >= 0 && xl + c < S;
        const size_t o = ok ? base + xl + c : 0;
        cp_async4(du + c, u + o, ok);
        cp_async4(db + c, b + o, ok);
      }
    }
  };

  // Stage t's rows one and two behind its newest (t = 0 is u itself).
  float prv[STEPS + 1][kRowCols];
  float cur[STEPS + 1][kRowCols];
#pragma unroll
  for (int t = 0; t <= STEPS; ++t) {
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) prv[t][c] = cur[t][c] = 0.0f;
  }

  const int r_first = R0 - halo;
  const int iters = (R1 - R0) + 2 * halo;
  for (int k = 0; k < kRowPrefetch; ++k) {
    issue(r_first + k, k);
    cp_async_commit();
  }
  for (int i = 0; i < iters; ++i) {
    const int p = r_first + i;
    issue(p + kRowPrefetch, i + kRowPrefetch);
    cp_async_commit();
    cp_async_wait<kRowPrefetch>();              // row p has landed
    const float4 up = ring_u[(i % Ru) * 32];
    float nw[kRowCols] = {up.x, up.y, up.z, up.w};

#pragma unroll
    for (int s = 1; s <= STEPS; ++s) {
      // Step s (local step s - 1) updates row p - s.
      const int q = p - s;
      const float4 bq = ring_b[((i - s + Rb) % Rb) * 32];
      const float left = __shfl_up_sync(0xffffffffu, cur[s - 1][3], 1);
      const float right = __shfl_down_sync(0xffffffffu, cur[s - 1][0], 1);
      const bool row_live = q >= 1 && q <= n - 1;
      const int color = (first_step + s - 1) & 1;
      const float c1 = wt.c1[s - 1];
      const float c2 = wt.c2[s - 1];
      float out[kRowCols];
#pragma unroll
      for (int c = 0; c < kRowCols; ++c) {
        const float v = cur[s - 1][c];
        const float w = c == 0 ? left : cur[s - 1][c - 1];
        const float e = c == kRowCols - 1 ? right : cur[s - 1][c + 1];
        const float nb = ((prv[s - 1][c] + nw[c]) + w) + e;
        const bool live = row_live && col_in[c];
        const float bv = lane_col(bq, c);
        if (rbgs) {
          out[c] = (live && ((q + xl + c) & 1) == color)
                       ? 0.25f * (bv + nb)
                       : v;
        } else {
          out[c] = live ? c1 * v + c2 * (bv + nb) : 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < kRowCols; ++c) {
        prv[s - 1][c] = cur[s - 1][c];
        cur[s - 1][c] = nw[c];
        nw[c] = out[c];
      }
    }

    // nw is u' at row p - STEPS; the residual stage takes row one behind.
    const int qo = p - STEPS;
    if (u_out != nullptr && out_lane && qo >= R0 && qo < R1) {
      store_row(u_out, S, qo, xl, nw, aligned);
    }
    if (want_r) {
      // The residual of row q = p - STEPS - 1 (every lane shuffles).
      const int q = qo - 1;
      const float left = __shfl_up_sync(0xffffffffu, cur[STEPS][3], 1);
      const float right = __shfl_down_sync(0xffffffffu, cur[STEPS][0], 1);
      if (out_lane && q >= R0 && q < R1) {
        const float4 bq = ring_b[((i - STEPS - 1 + Rb) % Rb) * 32];
        const bool row_live = q >= 1 && q <= n - 1;
        float r[kRowCols];
#pragma unroll
        for (int c = 0; c < kRowCols; ++c) {
          const float v = cur[STEPS][c];
          const float w = c == 0 ? left : cur[STEPS][c - 1];
          const float e = c == kRowCols - 1 ? right : cur[STEPS][c + 1];
          const float nb = ((prv[STEPS][c] + nw[c]) + w) + e;
          r[c] = row_live && col_in[c]
                     ? (lane_col(bq, c) - 4.0f * v) + nb
                     : 0.0f;
        }
        store_row(r_out, S, q, xl, r, aligned);
      }
    }
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) {
      prv[STEPS][c] = cur[STEPS][c];
      cur[STEPS][c] = nw[c];
    }
  }
  cp_async_wait<0>();
}

using RowKernel = void (*)(const float*, const float*, float*, float*, int,
                           int, int, int, int, StepWeights);

// row_march_kernel<steps>, for 0 <= steps <= S.
template <int S>
RowKernel row_kernel(int steps) {
  if (steps == S) return row_march_kernel<S>;
  if constexpr (S > 0) {
    return row_kernel<S - 1>(steps);
  } else {
    return nullptr;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

int tmt_stencil_max_steps(void) { return kMaxSteps; }

// One launch of 0..kMaxSteps steps.  u_out or r_out may be null (not
// written); with r_out the residual of the result is fused.  weights: host
// array [c1[0..count), c2[0..count)], local step s using entry s % count;
// ignored for RB-GS, whose half-step s updates colour (first_step + s) % 2.
int tmt_streamed(const void* u, const void* b, void* u_out, void* r_out,
                 int S, int n, int steps, int first_step, int rbgs,
                 const void* weights, int count, void* stream) {
  static int configured[kMaxSteps + 1][kMaxDevices] = {};
  if (steps < 0 || steps > kMaxSteps || S < 1) return cudaErrorInvalidValue;
  if (count < 1 || count > kMaxWeights) return cudaErrorInvalidValue;
  const float* host = static_cast<const float*>(weights);
  StepWeights wt;
  for (int j = 0; j < kMaxSteps; ++j) {
    wt.c1[j] = host[j % count];
    wt.c2[j] = host[count + j % count];
  }
  const RowKernel kernel = row_kernel<kMaxSteps>(steps);
  constexpr int ring_bytes = 32 * static_cast<int>(sizeof(float4));
  const int bytes =
      kRowWarps * ((kRowPrefetch + 2) + (steps + kRowPrefetch + 3)) *
      ring_bytes;
  cudaError_t err = allow_smem(kernel, bytes, configured[steps]);
  if (err != cudaSuccess) return err;
  const int halo = steps + (r_out != nullptr ? 1 : 0);
  const int hx = (halo + kRowCols - 1) & ~(kRowCols - 1);
  const int T = kRowWidth - 2 * hx;
  const long long warps = static_cast<long long>((S + T - 1) / T) *
                          ((S + kRowSegment - 1) / kRowSegment);
  const int blocks = static_cast<int>((warps + kRowWarps - 1) / kRowWarps);
  const int aligned = S % 4 == 0 && aligned16(u) && aligned16(b) &&
                      aligned16(u_out) && aligned16(r_out);
  kernel<<<blocks, kRowThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(b),
      static_cast<float*>(u_out), static_cast<float*>(r_out), S, n,
      first_step, rbgs, aligned, wt);
  return cudaGetLastError();
}

}  // extern "C"
