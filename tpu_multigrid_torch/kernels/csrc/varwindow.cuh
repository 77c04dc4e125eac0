// Shared-memory window machinery of the variable-coefficient kernels
// (varstencil.cu and vartransfer.cu).  A block owns one kVarTile x kVarTile
// output tile and holds, for the tile plus a halo of rings: two windows of
// the iterate, one of b, one of 1/diag and one per coefficient plane, all in
// shared memory, loaded once.  Every smoothing step then runs there
// (ghost-zone temporal blocking, as window.cuh): each step invalidates one
// ring of the window, and the halo is deep enough that no invalid cell
// reaches an output.
//
// Coefficient planes, in the order of kernels/varstencil.py::_flat_coef:
// NP = 5 holds [diag, E, S, SE, SW] of a symmetric operator, and the kernel
// derives W[i,j] = E[i,j-1], N[i,j] = S[i-1,j], NW[i,j] = SE[i-1,j-1] and
// NE[i,j] = SW[i-1,j+1], as the TPU kernel does (varstencil.py::
// _expand_sym).  NP = 9 appends the stored [W, N, NW, NE] of a nonsymmetric
// operator.  A derived plane is read one cell inward of the cell it serves,
// so every cell a step updates (rings >= 1) reads inside the window.
//
// Arithmetic: the TPU kernel's operations in its order, built with
// -fmad=false, so the plain torch versions in kernels/varstencil.py match
// bitwise: 1/diag where diag != 0 (else 0) from the diagonal plane, not the
// operator's stored inverse; the off-diagonal sum from zero over E, W, S, N,
// SE, SW, NW, NE; Jacobi (1 - w) v + (w / d) (b - off) with the per-step
// weight w itself; red-black Gauss-Seidel half-steps v = (b - off) / d on one
// colour, from the previous half-step's values (the 9-point stencil couples
// same-colour diagonal neighbours, so the update is double-buffered, not in
// place); the residual (b - diag v) - off.

#pragma once

#include "window.cuh"

namespace {

constexpr int kVarTile = 32;   // output tile side (even)

// Two iterate windows, b, 1/diag, and the nplanes coefficient planes.
int var_window_bytes(int nplanes, int halo) {
  const int w = kVarTile + 2 * halo;
  return (4 + nplanes) * w * w * static_cast<int>(sizeof(float));
}

// The deepest halo whose window fits in shared memory.
int var_max_halo(int nplanes) {
  int halo = 0;
  while (var_window_bytes(nplanes, halo + 1) <= kMaxSmemBytes) ++halo;
  return halo;
}

// sum over the 8 neighbours of coef * v, at window index k.
template <int NP>
__device__ __forceinline__ float var_off(const float* v, const float* c,
                                         int k, int w) {
  const int ww = w * w;
  const float* cE = c + ww;
  const float* cS = c + 2 * ww;
  const float* cSE = c + 3 * ww;
  const float* cSW = c + 4 * ww;
  float W, N, NW, NE;
  if (NP == 9) {
    W = c[5 * ww + k];
    N = c[6 * ww + k];
    NW = c[7 * ww + k];
    NE = c[8 * ww + k];
  } else {
    W = cE[k - 1];
    N = cS[k - w];
    NW = cSE[k - w - 1];
    NE = cSW[k - w + 1];
  }
  float acc = 0.0f;
  acc = acc + cE[k] * v[k + 1];
  acc = acc + W * v[k - 1];
  acc = acc + cS[k] * v[k + w];
  acc = acc + N * v[k - w];
  acc = acc + cSE[k] * v[k + w + 1];
  acc = acc + cSW[k] * v[k + w - 1];
  acc = acc + NW * v[k - w - 1];
  acc = acc + NE * v[k - w + 1];
  return acc;
}

// (b - diag v) - off at window index k (plane 0 is the diagonal).
template <int NP>
__device__ __forceinline__ float var_residual_at(const float* v,
                                                 const float* bw,
                                                 const float* c, int k,
                                                 int w) {
  return (bw[k] - c[k] * v[k]) - var_off<NP>(v, c, k, w);
}

// The NP coefficient planes of coef (NP, S, S) over the (w x w) window at
// global origin (r0, c0), and 1/diag; cells outside the array read 0.
template <int NP>
__device__ void load_coef_windows(float* c, float* invd,
                                  const float* __restrict__ coef, int S,
                                  int r0, int c0, int w) {
  const int ww = w * w;
  const size_t plane = (size_t)S * S;
  for (int li = threadIdx.y; li < w; li += blockDim.y) {
    const int gi = r0 + li;
    for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
      const int gj = c0 + lj;
      const int k = li * w + lj;
      const bool in = gi >= 0 && gi < S && gj >= 0 && gj < S;
      const size_t g = (size_t)gi * S + gj;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        c[p * ww + k] = in ? coef[p * plane + g] : 0.0f;
      }
      const float d = c[k];
      invd[k] = d != 0.0f ? 1.0f / d : 0.0f;
    }
  }
}

// Runs `steps` steps on the window; returns the buffer that holds the result
// (the other one is free).  Jacobi step s takes weights wt.c1 = 1 - w and
// wt.c2 = w of entry s % count; RB-GS half-step s updates colour s % 2, red
// ((i + j) even) first.  The outermost ring has no neighbours and keeps its
// value: it is invalid after the first step.
template <int NP>
__device__ float* var_smooth_window(float* v, float* spare, const float* bw,
                                    const float* c, const float* invd, int w,
                                    int r0, int c0, int n, int steps,
                                    int rbgs, const Weights& wt) {
  for (int s = 0; s < steps; ++s) {
    const float c1 = wt.c1[s % wt.count];
    const float cw = wt.c2[s % wt.count];
    const int color = s & 1;
    for (int li = threadIdx.y; li < w; li += blockDim.y) {
      const int gi = r0 + li;
      for (int lj = threadIdx.x; lj < w; lj += blockDim.x) {
        const int gj = c0 + lj;
        const int k = li * w + lj;
        float out = v[k];
        if (li > 0 && li < w - 1 && lj > 0 && lj < w - 1) {
          const bool inter = is_interior(gi, gj, n);
          if (rbgs) {
            if (inter && ((gi + gj) & 1) == color) {
              out = invd[k] * (bw[k] - var_off<NP>(v, c, k, w));
            }
          } else {
            out = inter ? c1 * v[k] +
                              (cw * invd[k]) *
                                  (bw[k] - var_off<NP>(v, c, k, w))
                        : 0.0f;
          }
        }
        spare[k] = out;
      }
    }
    float* t = v;
    v = spare;
    spare = t;
    __syncthreads();
  }
  return v;
}

}  // namespace
