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
// What the design does about it: the level-visit kernels of
// levelvisit3.cuh on the 3D window of window3.cuh, one block per fine tile,
// with a halo of steps + 2 layers for K1_3 and steps + 1 for K2_3 with the
// resnorm (steps without it).  The halo costs redundant loads and steps: at
// Chebyshev 3 a K1_3 tile of 14^2 x 22 sits in a 24^2 x 32 window.  A halo
// deeper than kMaxHalo3 does not fit in one launch: the wrapper splits the
// sweeps, K1_3 running its leading steps as smoothing passes alone (K2_3
// with no ec) and K2_3 its trailing ones, each launch told the index of its
// first step.
//
// Arithmetic: the Pallas kernels' order, as kernels/transfer3d.py's plain
// versions repeat it.  Built with -fmad=false: u' and rc match the plain
// versions bitwise.

#include "levelvisit3.cuh"

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
  if (ntaps > 0) {
    ConstOp3<true> op;
    err = make_taps(static_cast<const float*>(taps), ntaps, &op.tp);
    if (err != cudaSuccess) return err;
    return launch_smooth_restrict3(uu, bb, out, rcc, g, gc, steps,
                                   first_step, rbgs, wt, op, st);
  }
  ConstOp3<false> op;
  op.tp.count = 0;
  return launch_smooth_restrict3(uu, bb, out, rcc, g, gc, steps, first_step,
                                 rbgs, wt, op, st);
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
  if (ntaps > 0) {
    ConstOp3<true> op;
    err = make_taps(static_cast<const float*>(taps), ntaps, &op.tp);
    if (err != cudaSuccess) return err;
    return launch_prolong_smooth3(uu, bb, cc, out, part, sum, g, gc, steps,
                                  first_step, rbgs, wt, op, st);
  }
  ConstOp3<false> op;
  op.tp.count = 0;
  return launch_prolong_smooth3(uu, bb, cc, out, part, sum, g, gc, steps,
                                first_step, rbgs, wt, op, st);
}

}  // extern "C"
