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
// What the design does about it.  K1v_3 runs on zmarch3.cuh's z march: a
// 32 x 64 (y, x) window (32 x 32 past 5 steps) marching through a
// z-segment, the steps, residual and restriction a wavefront over the
// planes, each node updated once per step plus the xy halo, u and b
// arriving by cp.async a plane ahead, the couplings read per step through
// L1.  Its window of 24^2 x 32 in levelvisit3.cuh loaded 4.3x the cells it
// wrote at Chebyshev 3 and ran every step over all of them at one block per
// SM.  K2v_3 stays on levelvisit3.cuh's K2 template on window3.cuh's
// window, whose u, double buffer and b fill 216 KB of shared memory; the
// coefficient planes do not fit beside them, so every step reads a node's
// planes through the read-only path (__ldg), constant over the steps and
// served from L1/L2 after the window's first step.  The minus-direction
// transmissibilities are the stored planes one node back (tz at z-1, ty at
// y-1, tx at x-1), read at live nodes only; on a ghost-extended block a
// live node may sit on the array's first plane or row, whose node one back
// lies outside the array and couples with 0.  A halo deeper than a launch
// holds (kZMaxHalo for K1v_3, kMaxHalo3 for K2v_3, both 11) is split across
// launches by the wrapper, as for K1_3 / K2_3: K1v_3's leading steps run as
// K2v_3 passes.
//
// The ghost-extended forms (tmt_var_smooth_restrict_ext3,
// tmt_var_prolong_smooth_ext3: K1v_3-ext and K2v_3-local, replacing the
// Pallas kernels' origin / ghost variants, ::_var_smooth_restrict3 with
// `origin` and ::_var_prolong_smooth_local3) are the same templates on a
// block's grids (levelvisit3.cuh's ext_grids3), the coefficient stack
// ghost-inclusive.
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
#include "zmarch3.cuh"

namespace {

// The var operator of a window: P coefficient planes of the fine grid, each
// `plane` floats apart.  Its methods are called at live nodes only, with
// the node's array indices.
template <int P>
struct VarOp3 {
  const float* __restrict__ coef;
  size_t plane;
  int Sy, Sx;

  // The z march's view of a live node (zmarch3.cuh): its couplings to x+,
  // x-, y+, y-, z+, z- (c2 the reaction with 4 planes) and the inverse of
  // its diagonal, and the steps on a given neighbourhood, in terms()'s
  // order.  terms() below is the window's (K2v_3) form.
  struct Coef {
    float px, mx, py, my, pz, mz, c2, invd;
  };

  __device__ __forceinline__ Coef load(int gz, int gy, int gx) const {
    const size_t o = (static_cast<size_t>(gz) * Sy + gy) * Sx + gx;
    const float* c = coef;
    Coef k{};
    if (P == 6) {
      k.pz = __ldg(c + o);
      k.py = __ldg(c + plane + o);
      k.px = __ldg(c + 2 * plane + o);
      k.mz = __ldg(c + 3 * plane + o);
      k.my = __ldg(c + 4 * plane + o);
      k.mx = __ldg(c + 5 * plane + o);
    } else {
      k.pz = __ldg(c + o);
      k.mz = gz > 0 ? __ldg(c + o - static_cast<size_t>(Sy) * Sx) : 0.0f;
      k.py = __ldg(c + plane + o);
      k.my = gy > 0 ? __ldg(c + plane + o - Sx) : 0.0f;
      k.px = __ldg(c + 2 * plane + o);
      k.mx = gx > 0 ? __ldg(c + 2 * plane + o - 1) : 0.0f;
      if (P == 4) k.c2 = __ldg(c + 3 * plane + o);
    }
    return k;
  }

  __device__ __forceinline__ static float diag_of(const Coef& k) {
    const float d = ((k.pz + k.mz) + (k.py + k.my)) + (k.px + k.mx);
    return P == 4 ? d + k.c2 : d;
  }

  __device__ __forceinline__ static float off_of(const Coef& k, float xp,
                                                 float xm, float yp, float ym,
                                                 float zp, float zm) {
    return ((((k.px * xp + k.mx * xm) + k.py * yp) + k.my * ym) +
            k.pz * zp) +
           k.mz * zm;
  }

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
      mz = gz > 0 ? __ldg(c + o - static_cast<size_t>(Sy) * Sx) : 0.0f;
      py = __ldg(c + plane + o);
      my = gy > 0 ? __ldg(c + plane + o - Sx) : 0.0f;
      px = __ldg(c + 2 * plane + o);
      mx = gx > 0 ? __ldg(c + 2 * plane + o - 1) : 0.0f;
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

  __device__ __forceinline__ Coef couplings(int gz, int gy, int gx) const {
    Coef c = load(gz, gy, gx);
    c.invd = inverse(diag_of(c));
    return c;
  }

  __device__ __forceinline__ static float off_n(const Coef& c,
                                                const ZNbrs& n) {
    return off_of(c, n.xp, n.xm, n.yp, n.ym, n.zp, n.zm);
  }

  __device__ __forceinline__ float jacobi_n(const Coef& c, const ZNbrs& n,
                                            float b, float c1,
                                            float c2) const {
    return c1 * n.v + (c2 * c.invd) * (b + off_n(c, n));
  }

  __device__ __forceinline__ float gs_n(const Coef& c, const ZNbrs& n,
                                        float b) const {
    return c.invd * (b + off_n(c, n));
  }

  __device__ __forceinline__ float residual_n(const Coef& c, const ZNbrs& n,
                                              float b) const {
    return (b - diag_of(c) * n.v) + off_n(c, n);
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

// One K1v_3 launch on the grids g / gc: the z-march of zmarch3.cuh.
cudaError_t var_smooth_restrict3_on(const void* u, const void* b,
                                    const void* coef, void* u_out, void* rc,
                                    const Grid3& g, const Grid3& gc,
                                    int steps, int first_step, int rbgs,
                                    int nplanes, const void* weights,
                                    int count, void* stream) {
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  const float* ww = static_cast<const float*>(weights);
  float* out = static_cast<float*>(u_out);
  float* rcc = static_cast<float*>(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nplanes) {
    case 3:
      return launch_zmarch_smooth_restrict3(uu, bb, out, rcc, g, gc, steps,
                                            first_step, rbgs, ww, count,
                                            var_op<3>(coef, g), st);
    case 4:
      return launch_zmarch_smooth_restrict3(uu, bb, out, rcc, g, gc, steps,
                                            first_step, rbgs, ww, count,
                                            var_op<4>(coef, g), st);
    case 6:
      return launch_zmarch_smooth_restrict3(uu, bb, out, rcc, g, gc, steps,
                                            first_step, rbgs, ww, count,
                                            var_op<6>(coef, g), st);
    default:
      return cudaErrorInvalidValue;
  }
}

// One K2v_3 launch on the grids g / gc.
cudaError_t var_prolong_smooth3_on(const void* u, const void* b,
                                   const void* ec, const void* coef,
                                   void* u_out, void* partials,
                                   void* out_sum, const Grid3& g,
                                   const Grid3& gc, int steps,
                                   int first_step, int rbgs, int nplanes,
                                   const void* weights, int count,
                                   void* stream) {
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
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

}  // namespace

extern "C" {

// The deepest halo (steps + 2) of one K1v_3 launch: deeper smoothing runs
// its leading steps as K2v_3 passes alone (the wrapper's split plan).
int tmt_zmarch3_max_halo(void) { return kZMaxHalo; }

// coef: (nplanes, Sz, Sy, Sx) float32, nplanes 3, 4 or 6.  weights: host
// array [c1[0..count), c2[0..count)] with c1 = 1 - w, c2 = w (unused by
// RB-GS).  first_step: the global index of the launch's first step.
int tmt_var_smooth_restrict3(const void* u, const void* b, const void* coef,
                             void* u_out, void* rc, int Sz, int Sy, int Sx,
                             int Szc, int Syc, int Scx, int n, int steps,
                             int first_step, int rbgs, int nplanes,
                             const void* weights, int count, void* stream) {
  return var_smooth_restrict3_on(u, b, coef, u_out, rc, Grid3{Sz, Sy, Sx, n},
                                 Grid3{Szc, Syc, Scx, n / 2}, steps,
                                 first_step, rbgs, nplanes, weights, count,
                                 stream);
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
  return var_prolong_smooth3_on(u, b, ec, coef, u_out, partials, out_sum,
                                Grid3{Sz, Sy, Sx, n},
                                Grid3{Szc, Syc, Scx, n / 2}, steps,
                                first_step, rbgs, nplanes, weights, count,
                                stream);
}

// K1v_3-ext: K1v_3 on a ghost-extended (Rz, Ry, Sx) block at global origin
// (oz, oy) with (hz, hy) ghost cells a side (levelvisit3.cuh's ext_grids3),
// coef its ghost-inclusive (nplanes, Rz, Ry, Sx) stack; rc the whole
// (Rz / 2 + hz, Ry / 2 + hy, Scx) coarse block.
int tmt_var_smooth_restrict_ext3(const void* u, const void* b,
                                 const void* coef, void* u_out, void* rc,
                                 int Rz, int Ry, int Sx, int Scx, int n,
                                 int oz, int oy, int hz, int hy, int steps,
                                 int first_step, int rbgs, int nplanes,
                                 const void* weights, int count,
                                 void* stream) {
  Grid3 g, gc;
  cudaError_t err = ext_grids3(Rz, Ry, Sx, Scx, n, oz, oy, hz, hy, &g, &gc);
  if (err != cudaSuccess) return err;
  return var_smooth_restrict3_on(u, b, coef, u_out, rc, g, gc, steps,
                                 first_step, rbgs, nplanes, weights, count,
                                 stream);
}

// K2v_3-local: K2v_3 on a ghost-extended block and its coarse block ec (or
// null: a smoothing pass alone); with partials, out_sum[0] receives the sum
// of (b - A u')^2 over the owned live cells.
int tmt_var_prolong_smooth_ext3(const void* u, const void* b, const void* ec,
                                const void* coef, void* u_out,
                                void* partials, void* out_sum, int Rz,
                                int Ry, int Sx, int Scx, int n, int oz,
                                int oy, int hz, int hy, int steps,
                                int first_step, int rbgs, int nplanes,
                                const void* weights, int count,
                                void* stream) {
  Grid3 g, gc;
  cudaError_t err = ext_grids3(Rz, Ry, Sx, Scx, n, oz, oy, hz, hy, &g, &gc);
  if (err != cudaSuccess) return err;
  return var_prolong_smooth3_on(u, b, ec, coef, u_out, partials, out_sum, g,
                                gc, steps, first_step, rbgs, nplanes,
                                weights, count, stream);
}

}  // extern "C"
