// K1f_3 (fas_smooth_restrict3) and K2f_3 (fas_prolong_smooth3, fas_prolong_
// smooth_resnorm3): the two kernels of a 3D FAS level visit, for Hopper
// (sm_90a), on the pointwise family (7-point A + h^2 phi, Jacobi-Newton)
// and the quasilinear flux family (six edges, Picard-Jacobi), with the
// nonlinearities of fasnl.cuh.
//
// Replaces the Pallas TPU kernels tpu_multigrid/kernels/fas3d.py::
// _fas_smooth_restrict3 (K1f_3) and ::_fas_prolong_smooth3 (K2f_3), behind
// both families' entries (fas_*3 and qfas_*3).
//
//   K1f_3: `steps` nonlinear smoothing steps, the nonlinear residual, the
//          solution injection uc0 = u'[2I, 2J, 2K] and the FAS coarse
//          right-hand side bc = N_c(uc0) + R r (R = P^T / 2), both masked
//          to the coarse interior (zero past S/2 along any axis).
//   K2f_3: u <- mask(u + P ec) with trilinear P, then `steps` smoothing
//          steps; optionally one partial sum of (b - N(u'))^2 per block.
//          With ec null it is a smoothing pass alone.
//
// What bounds them: device-memory traffic, as for K1_3/K2_3 (~3.1 passes of
// the fine cube plus the eighth-size uc0); FAS is matrix-free, so no
// coefficient planes sit beside the window.
//
// What the design does about it: the level-visit templates of
// levelvisit3.cuh on the 3D window of window3.cuh (one block per fine tile,
// the tile plus a halo of steps + 2 layers for K1f_3, steps + 1 for K2f_3
// with the resnorm), with an operator whose `jacobi` is the nonlinear step
// and K1's FAS payload, which evaluates N_c on u' at the even nodes in
// shared memory.  A halo deeper than kMaxHalo3 splits over launches as
// K1_3's does (kernels/fas3d.py): leading smoothing passes (K2f_3 with no
// ec), then K1f_3.
//
// Arithmetic: the Pallas kernels' order, which kernels/fas3d.py's plain
// versions repeat: neighbour sums x, y, z; ap = (diag u - nbr) + h^2 phi(u);
// u + (omega (b - ap)) / (diag + h^2 phi(u)); the six edges in the order z+1,
// z-1, y+1, y-1, x+1, x-1; R blurs x, then y, then z and halves; P averages
// x, then y, then z.  Built with -fmad=false.

#include "fasnl.cuh"
#include "levelvisit3.cuh"

namespace {

// The operators run through smooth3's Jacobi branch only (rbgs = 0): `gs`
// exists for the template and returns the node unchanged.
struct BratuOp3 {
  BratuPhi phi;
  float omega, h2, h2c, diag;

  __device__ __forceinline__ float jacobi(const float* v, const float* bw,
                                          int k, int, int, int, float,
                                          float) const {
    const float x = v[k];
    const float pv = phi(x);
    const float ap = (diag * x - nbr7(v, k)) + h2 * pv;
    const float denom = diag + h2 * pv;
    return x + (omega * (bw[k] - ap)) / denom;
  }
  __device__ __forceinline__ float gs(const float* v, const float*, int k,
                                      int, int, int, float) const {
    return v[k];
  }
  __device__ __forceinline__ float residual(const float* v, const float* bw,
                                            int k, int, int, int) const {
    const float x = v[k];
    return bw[k] - ((diag * x - nbr7(v, k)) + h2 * phi(x));
  }
  // N_c at a coarse node whose uc0 is x; c(dz, dy, dx) is uc0 next to it.
  template <typename C>
  __device__ __forceinline__ float coarse_apply(float x, const C& c) const {
    const float nb = ((((c(0, 0, -1) + c(0, 0, 1)) + c(0, -1, 0)) +
                       c(0, 1, 0)) +
                      c(-1, 0, 0)) +
                     c(1, 0, 0);
    return (diag * x - nb) + h2c * phi(x);
  }
};

// The window neighbours of window index k, as QuadraticOp3 reads them.
struct FineNbr {
  const float* v;
  int k;
  __device__ __forceinline__ float operator()(int dz, int dy, int dx) const {
    return v[k + dz * kW3Plane + dy * kW3x + dx];
  }
};

struct QuadraticOp3 {
  QuadraticCoef a;
  float omega;

  template <typename C>
  __device__ __forceinline__ void flux_diag(float x, const C& c, float& flux,
                                            float& dg) const {
    flux = 0.0f;
    dg = 0.0f;
    edge_term(a, x, c(1, 0, 0), flux, dg);
    edge_term(a, x, c(-1, 0, 0), flux, dg);
    edge_term(a, x, c(0, 1, 0), flux, dg);
    edge_term(a, x, c(0, -1, 0), flux, dg);
    edge_term(a, x, c(0, 0, 1), flux, dg);
    edge_term(a, x, c(0, 0, -1), flux, dg);
  }
  __device__ __forceinline__ float jacobi(const float* v, const float* bw,
                                          int k, int, int, int, float,
                                          float) const {
    float flux, dg;
    flux_diag(v[k], FineNbr{v, k}, flux, dg);
    const float safe = dg > 0.0f ? dg : 1.0f;
    return v[k] + (omega * (bw[k] - flux)) / safe;
  }
  __device__ __forceinline__ float gs(const float* v, const float*, int k,
                                      int, int, int, float) const {
    return v[k];
  }
  __device__ __forceinline__ float residual(const float* v, const float* bw,
                                            int k, int, int, int) const {
    float flux, dg;
    flux_diag(v[k], FineNbr{v, k}, flux, dg);
    return bw[k] - flux;
  }
  template <typename C>
  __device__ __forceinline__ float coarse_apply(float x, const C& c) const {
    float flux, dg;
    flux_diag(x, c, flux, dg);
    return flux;
  }
};

BratuOp3 bratu_op3(const FasScalars& s) {
  return BratuOp3{BratuPhi{-s.scalar}, s.omega, s.h2, s.h2c, s.diag};
}

QuadraticOp3 quadratic_op3(const FasScalars& s) {
  return QuadraticOp3{QuadraticCoef{s.scalar}, s.omega};
}

// The FAS kernels take no per-step weights: one unused entry.
Weights no_weights() {
  Weights wt;
  for (int i = 0; i < kMaxWeights; ++i) {
    wt.c1[i] = 0.0f;
    wt.c2[i] = 0.0f;
  }
  wt.count = 1;
  return wt;
}

}  // namespace

extern "C" {

// kind: kKindBratu (scalar = lam) or kKindQuadratic (scalar = gamma).
// bc receives N_c(uc0) + R r, uc the injection.
int tmt_fas_smooth_restrict3(const void* u, const void* b, void* u_out,
                             void* uc, void* bc, int Sz, int Sy, int Sx,
                             int Szc, int Syc, int Scx, int n, int steps,
                             int kind, float scalar, float omega, float h2,
                             float diag, void* stream) {
  const FasScalars s{scalar, omega, h2, 4.0f * h2, diag};
  const Grid3 g{Sz, Sy, Sx, n};
  const Grid3 gc{Szc, Syc, Scx, n / 2};
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  float* out = static_cast<float*>(u_out);
  float* ucc = static_cast<float*>(uc);
  float* bcc = static_cast<float*>(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights wt = no_weights();
  if (kind == kKindBratu) {
    return launch_smooth_restrict3<BratuOp3, true>(
        uu, bb, out, bcc, g, gc, steps, 0, 0, wt, bratu_op3(s), st, ucc);
  }
  if (kind == kKindQuadratic) {
    return launch_smooth_restrict3<QuadraticOp3, true>(
        uu, bb, out, bcc, g, gc, steps, 0, 0, wt, quadratic_op3(s), st, ucc);
  }
  return cudaErrorInvalidValue;
}

// ec: the coarse correction, or null for a smoothing pass alone.  partials:
// tmt_prolong_smooth3_blocks floats, or null for no resnorm; then
// out_sum[0] receives the sum of (b - N(u'))^2 over the interior.
int tmt_fas_prolong_smooth3(const void* u, const void* b, const void* ec,
                            void* u_out, void* partials, void* out_sum,
                            int Sz, int Sy, int Sx, int Szc, int Syc,
                            int Scx, int n, int steps, int kind, float scalar,
                            float omega, float h2, float diag, void* stream) {
  const FasScalars s{scalar, omega, h2, 4.0f * h2, diag};
  const Grid3 g{Sz, Sy, Sx, n};
  const Grid3 gc{Szc, Syc, Scx, n / 2};
  const float* uu = static_cast<const float*>(u);
  const float* bb = static_cast<const float*>(b);
  const float* cc = static_cast<const float*>(ec);
  float* out = static_cast<float*>(u_out);
  float* part = static_cast<float*>(partials);
  float* sum = static_cast<float*>(out_sum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights wt = no_weights();
  if (kind == kKindBratu) {
    return launch_prolong_smooth3(uu, bb, cc, out, part, sum, g, gc, steps, 0,
                                  0, wt, bratu_op3(s), st);
  }
  if (kind == kKindQuadratic) {
    return launch_prolong_smooth3(uu, bb, cc, out, part, sum, g, gc, steps, 0,
                                  0, wt, quadratic_op3(s), st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
