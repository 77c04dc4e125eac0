// The nonlinearities the FAS kernels carry (fas.cu, fas3d.cu).  A kernel
// built once by nvcc cannot take an arbitrary callable, so the kernels take
// a closed set, selected by `kind` (core/nonlinear.py's KIND_*):
//
//   kKindBratu:     phi(u) = -lam e^u (phi' = phi), the pointwise family's
//                   Jacobi-Newton step;
//   kKindQuadratic: a(u) = 1 + gamma u^2, the quasilinear flux family's
//                   Picard-Jacobi step.
//
// Each evaluates what its torch class computes, in the same IEEE operations:
// (-lam) * expf(u) and 1 + (gamma u) u.  expf is the libdevice function
// (no __expf, no fast-math), the one torch's exp calls on float tensors.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kKindBratu = 1;
constexpr int kKindQuadratic = 2;

// The scalars of a FAS launch, rounded to f32 on the host as torch rounds
// a Python float against a float32 tensor.  `scalar` is lam for Bratu
// (negated here: -f32(lam) is f32(-lam), the factor torch multiplies by)
// and gamma for the quadratic coefficient; h2c = 4 h2 is the coarse level's
// h^2.
struct FasScalars {
  float scalar, omega, h2, h2c, diag;
};

struct BratuPhi {
  float neg_lam;
  __device__ __forceinline__ float operator()(float x) const {
    return neg_lam * expf(x);
  }
};

struct QuadraticCoef {
  float gamma;
  __device__ __forceinline__ float operator()(float m) const {
    return 1.0f + (gamma * m) * m;
  }
};

// Adds one edge's a(midpoint) (x - un) to `flux` and a(midpoint) to `dg`,
// in QuasilinearFluxOp's order.
__device__ __forceinline__ void edge_term(const QuadraticCoef& a, float x,
                                          float un, float& flux, float& dg) {
  const float ae = a(0.5f * (x + un));
  flux = flux + ae * (x - un);
  dg = dg + ae;
}

}  // namespace
