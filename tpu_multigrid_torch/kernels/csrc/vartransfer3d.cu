// K1v_3 (var_smooth_restrict3) and K2v_3 (var_prolong_smooth3,
// var_prolong_smooth_resnorm3): the two kernels of a 3D variable-
// coefficient multigrid level visit, for Hopper (sm_90a), on the 7-point
// flux stencil of VarStencilOp3D (3 transmissibility planes [tz, ty, tx],
// 4 with a reaction plane c2) or on the nonsymmetric Directional7Op (6
// planes [cpz, cpy, cpx, cmz, cmy, cmx]).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/vartransfer3d.py::
// _var_smooth_restrict3 (K1v_3) and ::_var_prolong_smooth3 (K2v_3).
//
//   K1v_3: `steps` Jacobi (per-step weights) or RB-GS steps, the residual
//          r = b - A u', its full-weighting restriction masked to the
//          coarse interior (the coarse tail past S/2 zero).
//   K2v_3: u <- mask(u + P ec), trilinear, then the steps; the resnorm
//          variant adds ||b - A u'||^2 as a fixed-order sum of per-block
//          partials.
//
// What bounds them: device-memory traffic.  Beside u, b (and ec) they read
// 3, 4 or 6 coefficient planes of the fine cube: 6 to 9 passes of it,
// against ~25 flops per node and step.
//
// What the design does about it: the level-visit kernels of
// levelvisit3.cuh on window3.cuh's 24^2 x 32 window, whose u, double buffer
// and b fill 216 KB of shared memory; the coefficient planes do not fit
// beside them, so every step reads a node's planes through the read-only
// path (__ldg), constant over the steps and served from L1/L2 after the
// window's first step.  The minus-direction transmissibilities are the
// stored planes one node back (tz at z-1, ty at y-1, tx at x-1), read at
// interior nodes only, where that node lies in the array.  A halo deeper
// than the window's kMaxHalo3 is split across launches by the wrapper, as
// for K1_3 / K2_3.
//
// Arithmetic: the Pallas kernels' order (_expand_t3 / _expand_dir3 and
// _offdiag3), which kernels/vartransfer3d.py's plain versions repeat:
//   diag = ((tz + tzm) + (ty + tym)) + (tx + txm) (+ c2), or for 6 planes
//          ((cpz + cmz) + (cpy + cmy)) + (cpx + cmx);
//   invd = 1 / diag where diag != 0, else 0 (computed here, not stored);
//   off  = tx u(x+1) + txm u(x-1) + ty u(y+1) + tym u(y-1) + tz u(z+1)
//          + tzm u(z-1), summed from the left;
//   Jacobi c1 u + (c2 invd)(b + off) with c1 = 1 - w, c2 = w; RB-GS
//   invd (b + off); residual (b - diag u) + off.
// Built with -fmad=false: u', rc match the plain versions bitwise.

#include "levelvisit3.cuh"

namespace {

// The var operator of a window: P coefficient planes of the fine grid, each
// `plane` floats apart.  Its methods are called at interior nodes only.
template <int P>
struct VarOp3 {
  const float* __restrict__ coef;
  size_t plane;
  int Sy, Sx;

  __device__ __forceinline__ void terms(const float* v, int k, int gz, int gy,
                                        int gx, float& diag,
                                        float& off) const {
    const size_t o = (static_cast<size_t>(gz) * Sy + gy) * Sx + gx;
    const float* c = coef;
    float px, mx, py, my, pz, mz;
    if (P == 6) {
      pz = __ldg(c + o);
      py = __ldg(c + plane + o);
      px = __ldg(c + 2 * plane + o);
      mz = __ldg(c + 3 * plane + o);
      my = __ldg(c + 4 * plane + o);
      mx = __ldg(c + 5 * plane + o);
    } else {
      pz = __ldg(c + o);
      mz = __ldg(c + o - static_cast<size_t>(Sy) * Sx);
      py = __ldg(c + plane + o);
      my = __ldg(c + plane + o - Sx);
      px = __ldg(c + 2 * plane + o);
      mx = __ldg(c + 2 * plane + o - 1);
    }
    diag = ((pz + mz) + (py + my)) + (px + mx);
    if (P == 4) diag = diag + __ldg(c + 3 * plane + o);
    off = ((((px * v[k + 1] + mx * v[k - 1]) + py * v[k + kW3x]) +
            my * v[k - kW3x]) +
           pz * v[k + kW3Plane]) +
          mz * v[k - kW3Plane];
  }

  __device__ __forceinline__ static float inverse(float diag) {
    return diag != 0.0f ? 1.0f / diag : 0.0f;
  }

  __device__ __forceinline__ float jacobi(const float* v, const float* bw,
                                          int k, int gz, int gy, int gx,
                                          float c1, float c2) const {
    float diag, off;
    terms(v, k, gz, gy, gx, diag, off);
    return c1 * v[k] + (c2 * inverse(diag)) * (bw[k] + off);
  }

  __device__ __forceinline__ float gs(const float* v, const float* bw, int k,
                                      int gz, int gy, int gx, float) const {
    float diag, off;
    terms(v, k, gz, gy, gx, diag, off);
    return inverse(diag) * (bw[k] + off);
  }

  __device__ __forceinline__ float residual(const float* v, const float* bw,
                                            int k, int gz, int gy,
                                            int gx) const {
    float diag, off;
    terms(v, k, gz, gy, gx, diag, off);
    return (bw[k] - diag * v[k]) + off;
  }
};

template <int P>
VarOp3<P> var_op(const void* coef, const Grid3& g) {
  VarOp3<P> op;
  op.coef = static_cast<const float*>(coef);
  op.plane = static_cast<size_t>(g.Sz) * g.Sy * g.Sx;
  op.Sy = g.Sy;
  op.Sx = g.Sx;
  return op;
}

}  // namespace

extern "C" {

// coef: (nplanes, Sz, Sy, Sx) float32, nplanes 3, 4 or 6.  weights: host
// array [c1[0..count), c2[0..count)] with c1 = 1 - w, c2 = w (unused by
// RB-GS).  first_step: the global index of the launch's first step.
int tmt_var_smooth_restrict3(const void* u, const void* b, const void* coef,
                             void* u_out, void* rc, int Sz, int Sy, int Sx,
                             int Szc, int Syc, int Scx, int n, int steps,
                             int first_step, int rbgs, int nplanes,
                             const void* weights, int count, void* stream) {
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const Grid3 g{Sz, Sy, Sx, n};
  const Grid3 gc{Szc, Syc, Scx, n / 2};
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  float* out = static_cast<float*>(u_out);
  float* rcc = static_cast<float*>(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nplanes) {
    case 3:
      return launch_smooth_restrict3(uu, bb, out, rcc, g, gc, steps,
                                     first_step, rbgs, wt,
                                     var_op<3>(coef, g), st);
    case 4:
      return launch_smooth_restrict3(uu, bb, out, rcc, g, gc, steps,
                                     first_step, rbgs, wt,
                                     var_op<4>(coef, g), st);
    case 6:
      return launch_smooth_restrict3(uu, bb, out, rcc, g, gc, steps,
                                     first_step, rbgs, wt,
                                     var_op<6>(coef, g), st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ec: the coarse correction, or null for a smoothing pass alone.  partials:
// tmt_prolong_smooth3_blocks floats, or null for no resnorm; then
// out_sum[0] receives the sum of (b - A u')^2 over the interior.
int tmt_var_prolong_smooth3(const void* u, const void* b, const void* ec,
                            const void* coef, void* u_out, void* partials,
                            void* out_sum, int Sz, int Sy, int Sx, int Szc,
                            int Syc, int Scx, int n, int steps,
                            int first_step, int rbgs, int nplanes,
                            const void* weights, int count, void* stream) {
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  const Grid3 g{Sz, Sy, Sx, n};
  const Grid3 gc{Szc, Syc, Scx, n / 2};
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  const float* cc = static_cast<const float*>(ec);
  float* out = static_cast<float*>(u_out);
  float* part = static_cast<float*>(partials);
  float* sum = static_cast<float*>(out_sum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nplanes) {
    case 3:
      return launch_prolong_smooth3(uu, bb, cc, out, part, sum, g, gc, steps,
                                    first_step, rbgs, wt, var_op<3>(coef, g),
                                    st);
    case 4:
      return launch_prolong_smooth3(uu, bb, cc, out, part, sum, g, gc, steps,
                                    first_step, rbgs, wt, var_op<4>(coef, g),
                                    st);
    case 6:
      return launch_prolong_smooth3(uu, bb, cc, out, part, sum, g, gc, steps,
                                    first_step, rbgs, wt, var_op<6>(coef, g),
                                    st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
