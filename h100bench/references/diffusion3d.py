"""Plain reference for -div(beta grad u) = f on the unit cube, homogeneous
Dirichlet boundaries, the vertex-centred 7-point flux stencil, geometric
multigrid.

Plain torch, written from the configuration file alone: it imports nothing
of the program and takes nothing the program built.  Arrays are the
(n+1)^3 node grids (z, y, x), boundary nodes included (always zero); the
caller cuts the program's padded arrays down to them.

* The coefficient: beta from the configuration's ``coefficient``
  (``coefficients.py``) at the cell centres in float64, rounded once to
  float32.
* The transmissibilities: the plane ``tx[i, j, k]`` couples node (i, j, k)
  to (i, j, k+1) and is the float32 mean of the four cells around that
  edge, 0.25 (((c00 + c01) + c10) + c11), likewise ``ty`` and ``tz``.
* The operator: (A u)_i = sum_f t_f (u_i - u_f) over the faces x+, x-, y+,
  y-, z+, z-, summed in that order, each t_f widened to the reference's
  type.  In float64 that is the flux form of the float32 planes, evaluated
  as exactly as float64 allows.
* The coarse levels: 2x2x2 cell means of the float64 beta, rounded to
  float32 and averaged as above.
* Chebyshev-Jacobi smoothing on [cheb_lo, 2] with the diagonal sum_f t_f,
  full weighting (4 / 8) P^T and trilinear prolongation (those of
  ``poisson_dirichlet.py``), the V-cycle, and the coarsest level solved by
  the float64 inverse of its interior matrix.

It runs in any floating type, so that the same code is the float64
reference and, in float32, the control that has to fail the check.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def _sibling(name: str, path: Path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return sys.modules[name]


poisson = _sibling("h100bench_reference_poisson_dirichlet_base",
                   HERE / "poisson_dirichlet.py")
coefficients = _sibling("h100bench_coefficients_for_reference",
                        HERE.parent / "coefficients.py")


def transmissibilities(cells64: np.ndarray, ns: Sequence[int]):
    """[(tz, ty, tx)] of each level n in ``ns`` (finest first): float32
    tensors on the (n+1)^3 node grid, from the finest (n, n, n) float64
    cell values, coarsened by 2x2x2 means in float64."""
    cells = np.asarray(cells64, np.float64)
    out = []
    for n in ns:
        c = torch.zeros((n + 2,) * 3, dtype=torch.float32)
        c[1:n + 1, 1:n + 1, 1:n + 1] = torch.from_numpy(
            cells.astype(np.float32))

        def view(di, dj, dk):
            return c[di:di + n + 1, dj:dj + n + 1, dk:dk + n + 1]

        # Edge (i, j, k) -> (i, j, k+1) lies between the cells (i-1..i,
        # j-1..j, k); likewise along y and z.
        tx = 0.25 * (((view(0, 0, 1) + view(0, 1, 1)) + view(1, 0, 1))
                     + view(1, 1, 1))
        ty = 0.25 * (((view(0, 1, 0) + view(0, 1, 1)) + view(1, 1, 0))
                     + view(1, 1, 1))
        tz = 0.25 * (((view(1, 0, 0) + view(1, 0, 1)) + view(1, 1, 0))
                     + view(1, 1, 1))
        out.append((tz, ty, tx))
        if n != ns[-1]:
            m = n // 2
            cells = cells.reshape(m, 2, m, 2, m, 2).mean((1, 3, 5))
    return out


class Reference(poisson.Reference):
    """The reference solver for one configuration, in ``dtype`` on
    ``device``."""

    def __init__(self, config: dict, dtype, device):
        if config["ndim"] != 3 or config["stencil"] != "flux7":
            raise ValueError("this reference takes the 3D flux7 stencil")
        mg = config["multigrid"]
        if mg["smoother"] != "chebyshev":
            raise ValueError("the reference smooths with Chebyshev only")
        self.d = 3
        self.ns = [2 ** lvl for lvl in range(mg["finest_level"],
                                             mg["coarsest_level"] - 1, -1)]
        self.w1 = poisson.chebyshev_weights(mg["nu1"], mg["cheb_lo"])
        self.w2 = poisson.chebyshev_weights(mg["nu2"], mg["cheb_lo"])
        self.scale = 4.0 / 2 ** self.d
        self.dtype, self.device = dtype, device
        beta = coefficients.callable_of(config["coefficient"])
        cells = coefficients.cell_values(beta, self.ns[0]).numpy()
        self.t = [tuple(p.to(device=device, dtype=dtype) for p in level)
                  for level in transmissibilities(cells, self.ns)]
        del cells
        self.diag = [self._diag(k) for k in range(len(self.ns))]
        self.coarse_inv = torch.as_tensor(
            np.linalg.inv(self.interior_matrix(len(self.ns) - 1)),
            device=device).to(dtype)

    # -- the operator ------------------------------------------------------

    def _diag(self, k: int):
        tz, ty, tx = self.t[k]
        c, m = slice(1, -1), slice(0, -2)
        return (((((tx[c, c, c] + tx[c, c, m]) + ty[c, c, c]) + ty[c, m, c])
                 + tz[c, c, c]) + tz[m, c, c])

    def apply(self, u, k: int = 0):
        """A u on the interior, zero on the boundary (leading axes are a
        batch)."""
        tz, ty, tx = self.t[k]
        c, m, p = slice(1, -1), slice(0, -2), slice(2, None)
        e = (Ellipsis,)
        uc = u[e + (c, c, c)]
        acc = tx[c, c, c] * (uc - u[e + (c, c, p)])
        acc = acc + tx[c, c, m] * (uc - u[e + (c, c, m)])
        acc = acc + ty[c, c, c] * (uc - u[e + (c, p, c)])
        acc = acc + ty[c, m, c] * (uc - u[e + (c, m, c)])
        acc = acc + tz[c, c, c] * (uc - u[e + (p, c, c)])
        acc = acc + tz[m, c, c] * (uc - u[e + (m, c, c)])
        out = torch.zeros_like(u)
        out[e + (c, c, c)] = acc
        return out

    def residual(self, u, b, k: int = 0):
        return b - self.apply(u, k)

    def smooth(self, u, b, weights: List[float], k: int = 0):
        c = self.inner()
        for w in weights:
            r = self.residual(u, b, k)
            u = u.clone()
            u[c] = u[c] + (w / self.diag[k]) * r[c]
        return u

    def interior_matrix(self, k: int) -> np.ndarray:
        """The float64 interior matrix of level ``k``, column j the
        operator applied to the j-th interior unit grid."""
        n = self.ns[k]
        m = (n - 1) ** 3
        saved = self.t[k]
        self.t[k] = tuple(t.double() for t in saved)
        e = torch.zeros((m,) + (n + 1,) * 3, dtype=torch.float64,
                        device=saved[0].device)
        e[(slice(None),) + self.inner()] = torch.eye(
            m, dtype=torch.float64, device=e.device).reshape(
                (m,) + (n - 1,) * 3)
        cols = self.apply(e, k)[(slice(None),) + self.inner()]
        self.t[k] = saved
        return cols.reshape(m, m).T.cpu().numpy()

    # -- cycles ------------------------------------------------------------

    def vcycle(self, u, b, k: int = 0):
        if k == len(self.ns) - 1:
            return self.coarse_solve(b)
        u = self.smooth(u, b, self.w1, k)
        rc = self.restrict(self.residual(u, b, k))
        ec = self.vcycle(torch.zeros_like(rc), rc, k + 1)
        u = u + self.prolong(ec)
        return self.smooth(u, b, self.w2, k)
