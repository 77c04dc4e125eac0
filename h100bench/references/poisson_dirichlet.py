"""Plain reference for -lap(u) = f on the unit square or cube, homogeneous
Dirichlet boundaries, geometric multigrid.

Plain torch, written from the configuration file alone: it imports nothing
of the program and takes nothing the program built.  Arrays are the
(n+1)^d node grids, boundary nodes included (always zero); the caller cuts
the program's padded arrays down to them.

* The operator, from the configuration's ``stencil``: ``fem5`` is the P1
  finite-element 5-point stencil (diagonal 4, neighbours -1) and ``fd7``
  the 7-point stencil (diagonal 6, neighbours -1), both for b = f h^2.
* Full-weighting restriction R = (4 / 2^d) P^T, the scale that keeps the
  coarse equation consistent with b = f h^2 on every level, and
  multilinear prolongation P.
* Chebyshev-Jacobi smoothing: the k-step schedule's weights are the
  reciprocals of the roots of the degree-k Chebyshev polynomial on
  [cheb_lo, 2], largest first; a step is u += (w / diag) (b - A u) on the
  interior.
* The coarsest level is solved exactly by the inverse of its interior
  matrix, assembled and inverted in float64 with numpy.
* The V-cycle: nu1 steps, restrict the residual, the coarse correction
  from zero, prolong and add, nu2 steps.

It runs in any floating type, so that the same code is the f64 reference
and, in a lower precision, the control that has to fail the check.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

DIAG = {"fem5": 4.0, "fd7": 6.0}


class Reference:
    """The reference solver for one configuration, in ``dtype`` on
    ``device``."""

    def __init__(self, config: dict, dtype, device):
        self.d = config["ndim"]
        self.diag = DIAG[config["stencil"]]
        if config["stencil"] not in {2: ("fem5",), 3: ("fd7",)}[self.d]:
            raise ValueError(f"stencil {config['stencil']} is not "
                             f"{self.d}-dimensional")
        mg = config["multigrid"]
        if mg["smoother"] != "chebyshev":
            raise ValueError("the reference smooths with Chebyshev only")
        self.ns = [2 ** lvl for lvl in range(mg["finest_level"],
                                             mg["coarsest_level"] - 1, -1)]
        self.w1 = chebyshev_weights(mg["nu1"], mg["cheb_lo"])
        self.w2 = chebyshev_weights(mg["nu2"], mg["cheb_lo"])
        self.scale = 4.0 / 2 ** self.d
        self.dtype, self.device = dtype, device
        inv = np.linalg.inv(interior_matrix(self.ns[-1], self.d, self.diag))
        self.coarse_inv = torch.as_tensor(inv, device=device).to(dtype)

    # -- the operator ------------------------------------------------------

    def inner(self):
        return (slice(1, -1),) * self.d

    def apply(self, u):
        """A u on the interior, zero on the boundary."""
        out = torch.zeros_like(u)
        c = self.inner()
        acc = self.diag * u[c]
        for ax in range(self.d):
            lo = list(c)
            hi = list(c)
            lo[ax] = slice(0, -2)
            hi[ax] = slice(2, None)
            acc = acc - u[tuple(lo)] - u[tuple(hi)]
        out[c] = acc
        return out

    def residual(self, u, b):
        return b - self.apply(u)

    def smooth(self, u, b, weights):
        c = self.inner()
        for w in weights:
            r = self.residual(u, b)
            u = u.clone()
            u[c] = u[c] + (w / self.diag) * r[c]
        return u

    # -- transfers ---------------------------------------------------------

    def restrict(self, r):
        """Full weighting, (2m+1)^d -> (m+1)^d, times 4 / 2^d."""
        t = r
        for ax in range(self.d):
            t = t.movedim(ax, 0)
            even = t[0::2].clone()
            odd = t[1::2]
            even[1:-1] = even[1:-1] + 0.5 * (odd[:-1] + odd[1:])
            t = even.movedim(0, ax)
        t = self.scale * t
        out = torch.zeros_like(t)
        out[self.inner()] = t[self.inner()]
        return out

    def prolong(self, e):
        """Multilinear interpolation, (m+1)^d -> (2m+1)^d."""
        t = e
        for ax in range(self.d):
            t = t.movedim(ax, 0)
            m = t.shape[0] - 1
            f = t.new_zeros((2 * m + 1,) + tuple(t.shape[1:]))
            f[0::2] = t
            f[1::2] = 0.5 * (t[:-1] + t[1:])
            t = f.movedim(0, ax)
        return t

    # -- cycles ------------------------------------------------------------

    def coarse_solve(self, b):
        m = self.ns[-1] - 1
        c = self.inner()
        x = torch.mv(self.coarse_inv, b[c].reshape(-1))
        out = torch.zeros_like(b)
        out[c] = x.reshape((m,) * self.d)
        return out

    def vcycle(self, u, b, k: int = 0):
        if k == len(self.ns) - 1:
            return self.coarse_solve(b)
        u = self.smooth(u, b, self.w1)
        rc = self.restrict(self.residual(u, b))
        ec = self.vcycle(torch.zeros_like(rc), rc, k + 1)
        u = u + self.prolong(ec)
        return self.smooth(u, b, self.w2)

    def cycles(self, b, count: int):
        """``count`` V-cycles from zero."""
        u = torch.zeros_like(b)
        for _ in range(count):
            u = self.vcycle(u, b)
        return u

    def refine(self, b, tol: float, max_iters: int, stall_factor=0.9):
        """Iterative refinement with one V-cycle as the inner solve, the
        iterate and residual in this reference's own type: u += MG(b - A u)
        until ||r|| <= tol ||b||, or an iteration that does not reduce the
        residual by ``stall_factor``, or ``max_iters``."""
        u = torch.zeros_like(b)
        r = b
        r0 = rnorm = float(norm(r))
        prev = math.inf
        it = 0
        while (it < max_iters and rnorm > tol * r0
               and rnorm < stall_factor * prev):
            u = u + self.vcycle(torch.zeros_like(r), r)
            r = self.residual(u, b)
            prev, rnorm = rnorm, float(norm(r))
            it += 1
        return u


def chebyshev_weights(k: int, lo: float, hi: float = 2.0) -> List[float]:
    roots = [(lo + hi) / 2 + (hi - lo) / 2 * math.cos(
        math.pi * (2 * j + 1) / (2 * k)) for j in range(k)]
    return sorted((1.0 / t for t in roots), reverse=True)


def interior_matrix(n: int, d: int, diag: float) -> np.ndarray:
    """The (n-1)^d interior matrix of the (2d+1)-point stencil."""
    m1 = n - 1
    idx = np.arange(m1 ** d).reshape((m1,) * d)
    a = diag * np.eye(m1 ** d)
    for ax in range(d):
        lo = [slice(None)] * d
        hi = [slice(None)] * d
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        rows, cols = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        a[rows, cols] = -1.0
        a[cols, rows] = -1.0
    return a


def norm(x):
    """The 2-norm, accumulated in at least float32."""
    x = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    return torch.sqrt(torch.sum(x * x))
