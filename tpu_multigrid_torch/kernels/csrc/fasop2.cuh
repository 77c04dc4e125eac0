// The 2D FAS operator policies of the level-visit kernels: the pointwise
// family's Jacobi-Newton step over the 5-point stencil and the quasilinear
// flux family's Picard-Jacobi step, each with its nonlinear residual and
// its coarse apply N_c at a coarse node.  The step loop (window.cuh's
// smooth_window_op) runs them on the padded level (fas.cu) and on
// ghost-extended blocks (localfas.cu): they read only the window, so they
// are the same on either geometry.

#pragma once

#include "fasnl.cuh"
#include "window.cuh"

namespace {

// The pointwise family with phi = -lam e^u: the Jacobi-Newton step, the
// residual, and N_c at a coarse node (coarse neighbours outside the coarse
// interior read 0).
struct BratuOp2 {
  BratuPhi phi;
  float omega, h2, h2c, diag;

  __device__ __forceinline__ float step(const float* v, const float* bw,
                                        int k, int w) const {
    const float x = v[k];
    const float pv = phi(x);
    const float ap = (diag * x - nbr(v, k, w)) + h2 * pv;
    const float denom = diag + h2 * pv;
    return x + (omega * (bw[k] - ap)) / denom;
  }
  __device__ __forceinline__ float residual(const float* v, const float* bw,
                                            int k, int w) const {
    const float x = v[k];
    return bw[k] - ((diag * x - nbr(v, k, w)) + h2 * phi(x));
  }
  // c(di, dj): uc0 at coarse (I + di, J + dj), v at fine k + 2 (di w + dj).
  template <typename C>
  __device__ __forceinline__ float capply(float x, const C& c) const {
    const float nb = ((c(-1, 0) + c(1, 0)) + c(0, -1)) + c(0, 1);
    return (diag * x - nb) + h2c * phi(x);
  }
};

// The quasilinear flux family with a(u) = 1 + gamma u^2: the Picard-Jacobi
// step, the residual, and the flux form on uc0 (h-independent).
struct QuadraticOp2 {
  QuadraticCoef a;
  float omega;

  template <typename C>
  __device__ __forceinline__ void flux_diag(float x, const C& c, float& flux,
                                            float& dg) const {
    flux = 0.0f;
    dg = 0.0f;
    edge_term(a, x, c(0, 1), flux, dg);
    edge_term(a, x, c(0, -1), flux, dg);
    edge_term(a, x, c(1, 0), flux, dg);
    edge_term(a, x, c(-1, 0), flux, dg);
  }
  __device__ __forceinline__ float step(const float* v, const float* bw,
                                        int k, int w) const {
    float flux, dg;
    flux_diag(v[k], [&](int di, int dj) { return v[k + di * w + dj]; }, flux,
              dg);
    const float safe = dg > 0.0f ? dg : 1.0f;
    return v[k] + (omega * (bw[k] - flux)) / safe;
  }
  __device__ __forceinline__ float residual(const float* v, const float* bw,
                                            int k, int w) const {
    float flux, dg;
    flux_diag(v[k], [&](int di, int dj) { return v[k + di * w + dj]; }, flux,
              dg);
    return bw[k] - flux;
  }
  template <typename C>
  __device__ __forceinline__ float capply(float x, const C& c) const {
    float flux, dg;
    flux_diag(x, c, flux, dg);
    return flux;
  }
};

BratuOp2 bratu_op2(const FasScalars& s) {
  return BratuOp2{BratuPhi{-s.scalar}, s.omega, s.h2, s.h2c, s.diag};
}

QuadraticOp2 quadratic_op2(const FasScalars& s) {
  return QuadraticOp2{QuadraticCoef{s.scalar}, s.omega};
}

}  // namespace
