// K1_3 (smooth_restrict3) and K2_3 (prolong_smooth3, prolong_smooth_
// resnorm3): the two kernels of a 3D multigrid level visit, for Hopper
// (sm_90a), on the 7-point Poisson stencil or on a static 3x3x3 stencil
// (the 19-point Mehrstellen operator).
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/transfer3d.py::
// _smooth_restrict3 (K1_3) and ::_prolong_smooth3 (K2_3).
//
//   K1_3: `steps` Jacobi (per-step weights) or RB-GS steps on u, then
//         r = b - A u, then the full-weighting restriction R = P^T / 2 of r
//         to the coarse grid, masked to the coarse interior; the coarse
//         nodes past S/2 along any axis are zero.  Writes u' and rc.
//   K2_3: u <- mask(u + P ec) with trilinear P, then `steps` smoothing
//         steps.  Writes u'; the resnorm variant also writes one partial sum
//         of (b - A u')^2 per block, which a one-block kernel adds up.
//
// What bounds them: device-memory traffic.  K1_3 reads u and b and writes
// u' and the eighth-size rc; K2_3 reads u, b and the eighth-size ec and
// writes u': about 3.1 passes of the fine cube each, against ~10 flops per
// node and step (~40 with the 19-point stencil), far below the card's
// flop-per-byte balance.  Unfused, every sweep, the residual and each
// transfer would be passes of their own.
//
// What the design does about it.  K1_3 on the 7-point stencil runs on
// zmarch3.cuh's z march (ZConstOp3 below), as K1v_3 does: a 32 x 64 (y, x)
// window (32 x 32 past 5 steps) marching through a z-segment, the steps,
// residual and restriction a wavefront over the planes, each node updated
// once per step plus the xy halo, u and b arriving by cp.async a plane
// ahead.  On levelvisit3.cuh's window a K1_3 tile of 14^2 x 22 sat in a
// 24^2 x 32 window at Chebyshev 3, every step over all of it at one block
// per SM.  K2_3, and K1_3 on static taps (the
// 19-point weights, whose edge neighbours the march's ZNbrs does not
// hold), stay on the level-visit kernels of levelvisit3.cuh on the 3D
// window of window3.cuh, one block per fine tile, with a halo of steps + 2
// layers for K1_3 and steps + 1 for K2_3 with the resnorm (steps without
// it).  A halo deeper than a launch holds (kZMaxHalo for the march,
// kMaxHalo3 for the window, both 11) does not fit in one launch: the
// wrapper splits the sweeps, K1_3 running its leading steps as smoothing
// passes alone (K2_3 with no ec) and K2_3 its trailing ones, each launch
// told the index of its first step.
//
// The ghost-extended forms (tmt_smooth_restrict_ext3,
// tmt_prolong_smooth_ext3: K1_3-ext and K2_3-local, replacing the Pallas
// kernels' origin / ghost variants, ::_smooth_restrict3 with `origin` and
// ::_prolong_smooth_local3) run the same templates on a block's grids
// (levelvisit3.cuh's ext_grids3): masks and colours from global indices,
// the coarse block written whole, the resnorm over the owned cells.
//
// Arithmetic: the Pallas kernels' order, as kernels/transfer3d.py's plain
// versions repeat it.  Built with -fmad=false: u' and rc match the plain
// versions bitwise.

#include "levelvisit3.cuh"
#include "zmarch3.cuh"

namespace {

// The 7-point stencil in the z march's terms (zmarch3.cuh), term for term
// window3.cuh's ConstOp3<false>: nbr = ((((x- + x+) + y-) + y+) + z-) + z+;
// Jacobi c1 v + c2 (b + nbr); RB-GS c2 (b + nbr), with c2 the host's RB-GS
// coefficient, carried here since gs_n takes no weight; residual
// (b - 6 v) + nbr.  No couplings to load.
struct ZConstOp3 {
  struct Coef {};
  float gs_c2;

  __device__ __forceinline__ Coef couplings(int, int, int) const {
    return Coef{};
  }
  __device__ __forceinline__ static float nbr(const ZNbrs& n) {
    return ((((n.xm + n.xp) + n.ym) + n.yp) + n.zm) + n.zp;
  }
  __device__ __forceinline__ float jacobi_n(const Coef&, const ZNbrs& n,
                                            float b, float c1,
                                            float c2) const {
    return c1 * n.v + c2 * (b + nbr(n));
  }
  __device__ __forceinline__ float gs_n(const Coef&, const ZNbrs& n,
                                        float b) const {
    return gs_c2 * (b + nbr(n));
  }
  __device__ __forceinline__ float residual_n(const Coef&, const ZNbrs& n,
                                              float b) const {
    return (b - 6.0f * n.v) + nbr(n);
  }
};

// K1_3's z-march kernels, named smooth_restrict3_kernel in a trace as the
// window's K1_3 was (levelvisit3.cuh's template of that name stays outside
// this namespace).
namespace zmarch {

template <typename Op, int STEPS>
__global__ void __launch_bounds__(kZThreads, 1)
smooth_restrict3_kernel(const float* __restrict__ u,
                        const float* __restrict__ b,
                        float* __restrict__ u_out, float* __restrict__ rc,
                        Grid3 g, Grid3 gc, int cz, int first_step, int rbgs,
                        ZWeights wt, Op op) {
  zmarch_smooth_restrict3<Op, STEPS>(u, b, u_out, rc, g, gc, cz, first_step,
                                     rbgs, wt, op);
}

// smooth_restrict3_kernel<Op, steps>, for 0 <= steps <= S.
template <typename Op, int S>
ZKernel<Op> pick(int steps) {
  if (steps == S) return smooth_restrict3_kernel<Op, S>;
  if constexpr (S > 0) {
    return pick<Op, S - 1>(steps);
  } else {
    return nullptr;
  }
}

}  // namespace zmarch

// The 7-point stencil (ntaps 0) or static weights from the host's taps.
cudaError_t const_op(const void* taps, int ntaps, ConstOp3<true>* op27,
                     ConstOp3<false>* op7) {
  op7->tp.count = 0;
  if (ntaps == 0) return cudaSuccess;
  return make_taps(static_cast<const float*>(taps), ntaps, &op27->tp);
}

// One K1_3 launch on the grids g / gc: the 7-point stencil (ntaps 0) on
// the z march, static taps on the window.
cudaError_t smooth_restrict3_on(const void* u, const void* b, void* u_out,
                                void* rc, const Grid3& g, const Grid3& gc,
                                int steps, int first_step, int rbgs,
                                const void* weights, int count,
                                const void* taps, int ntaps, void* stream) {
  const float* ww = static_cast<const float*>(weights);
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  float* out = static_cast<float*>(u_out);
  float* rcc = static_cast<float*>(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntaps == 0) {
    if (count < 1) return cudaErrorInvalidValue;
    return launch_zmarch_smooth_restrict3(
        uu, bb, out, rcc, g, gc, steps, first_step, rbgs, ww, count,
        ZConstOp3{ww[count]}, st, zmarch::pick<ZConstOp3, kZMaxSteps>);
  }
  Weights wt;
  cudaError_t err = make_weights(ww, count, &wt);
  if (err != cudaSuccess) return err;
  ConstOp3<true> op27;
  err = make_taps(static_cast<const float*>(taps), ntaps, &op27.tp);
  if (err != cudaSuccess) return err;
  return launch_smooth_restrict3(uu, bb, out, rcc, g, gc, steps, first_step,
                                 rbgs, wt, op27, st);
}

// One K2_3 launch on the grids g / gc.
cudaError_t prolong_smooth3_on(const void* u, const void* b, const void* ec,
                               void* u_out, void* partials, void* out_sum,
                               const Grid3& g, const Grid3& gc, int steps,
                               int first_step, int rbgs, const void* weights,
                               int count, const void* taps, int ntaps,
                               void* stream) {
  Weights wt;
  cudaError_t err =
      make_weights(static_cast<const float*>(weights), count, &wt);
  if (err != cudaSuccess) return err;
  ConstOp3<true> op27;
  ConstOp3<false> op7;
  err = const_op(taps, ntaps, &op27, &op7);
  if (err != cudaSuccess) return err;
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  const float* cc = static_cast<const float*>(ec);
  float* out = static_cast<float*>(u_out);
  float* part = static_cast<float*>(partials);
  float* sum = static_cast<float*>(out_sum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntaps > 0) {
    return launch_prolong_smooth3(uu, bb, cc, out, part, sum, g, gc, steps,
                                  first_step, rbgs, wt, op27, st);
  }
  return launch_prolong_smooth3(uu, bb, cc, out, part, sum, g, gc, steps,
                                first_step, rbgs, wt, op7, st);
}

}  // namespace

extern "C" {

int tmt_window3_max_halo(void) { return kMaxHalo3; }

int tmt_prolong_smooth3_blocks(int Sz, int Sy, int Sx, int steps) {
  return prolong_smooth3_blocks(Sz, Sy, Sx, steps);
}

// weights: host array [c1[0..count), c2[0..count)] (RB-GS: c2[0] is its
// coefficient).  taps: host array [dz, dy, dx, w] * ntaps + [centre], or
// ntaps 0 for the 7-point stencil.  first_step: the global index of the
// launch's first step (its RB-GS colour).
int tmt_smooth_restrict3(const void* u, const void* b, void* u_out, void* rc,
                         int Sz, int Sy, int Sx, int Szc, int Syc, int Scx,
                         int n, int steps, int first_step, int rbgs,
                         const void* weights, int count, const void* taps,
                         int ntaps, void* stream) {
  return smooth_restrict3_on(u, b, u_out, rc, Grid3{Sz, Sy, Sx, n},
                             Grid3{Szc, Syc, Scx, n / 2}, steps, first_step,
                             rbgs, weights, count, taps, ntaps, stream);
}

// ec: the coarse correction, or null for a smoothing pass alone.  partials:
// tmt_prolong_smooth3_blocks floats, or null for no resnorm; then
// out_sum[0] receives the sum of (b - A u')^2 over the interior.
int tmt_prolong_smooth3(const void* u, const void* b, const void* ec,
                        void* u_out, void* partials, void* out_sum, int Sz,
                        int Sy, int Sx, int Szc, int Syc, int Scx, int n,
                        int steps, int first_step, int rbgs,
                        const void* weights, int count, const void* taps,
                        int ntaps, void* stream) {
  return prolong_smooth3_on(u, b, ec, u_out, partials, out_sum,
                            Grid3{Sz, Sy, Sx, n}, Grid3{Szc, Syc, Scx, n / 2},
                            steps, first_step, rbgs, weights, count, taps,
                            ntaps, stream);
}

// K1_3-ext: K1_3 (7-point) on a ghost-extended (Rz, Ry, Sx) block at global
// origin (oz, oy) with (hz, hy) ghost cells a side (levelvisit3.cuh's
// ext_grids3); rc the whole (Rz / 2 + hz, Ry / 2 + hy, Scx) coarse block.
int tmt_smooth_restrict_ext3(const void* u, const void* b, void* u_out,
                             void* rc, int Rz, int Ry, int Sx, int Scx, int n,
                             int oz, int oy, int hz, int hy, int steps,
                             int first_step, int rbgs, const void* weights,
                             int count, void* stream) {
  Grid3 g, gc;
  cudaError_t err = ext_grids3(Rz, Ry, Sx, Scx, n, oz, oy, hz, hy, &g, &gc);
  if (err != cudaSuccess) return err;
  return smooth_restrict3_on(u, b, u_out, rc, g, gc, steps, first_step, rbgs,
                             weights, count, nullptr, 0, stream);
}

// K2_3-local: K2_3 (7-point) on a ghost-extended block and its coarse block
// ec (or null: a smoothing pass alone); with partials, out_sum[0] receives
// the sum of (b - A u')^2 over the owned live cells.
int tmt_prolong_smooth_ext3(const void* u, const void* b, const void* ec,
                            void* u_out, void* partials, void* out_sum,
                            int Rz, int Ry, int Sx, int Scx, int n, int oz,
                            int oy, int hz, int hy, int steps, int first_step,
                            int rbgs, const void* weights, int count,
                            void* stream) {
  Grid3 g, gc;
  cudaError_t err = ext_grids3(Rz, Ry, Sx, Scx, n, oz, oy, hz, hy, &g, &gc);
  if (err != cudaSuccess) return err;
  return prolong_smooth3_on(u, b, ec, u_out, partials, out_sum, g, gc, steps,
                            first_step, rbgs, weights, count, nullptr, 0,
                            stream);
}

}  // extern "C"
