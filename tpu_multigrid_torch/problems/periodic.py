"""Periodic Poisson: -lap(u) = f on the unit torus.

Both axes are periodic.  Grids are (n, n) arrays of the n = 2^l unique
nodes (node n is node 0), h = 1/n, and neighbour access is ``torch.roll``,
whose wrap-around is exactly the torus topology, so the operator needs no
masks.

The operator is singular, with the constants as its null space:

* the right-hand side is mean-projected (``f`` must integrate to zero up to
  quadrature; the projection enforces it exactly);
* every smoother, residual and transfer here preserves the mean-zero
  subspace (row sums are zero, R and P have matching constants), so no
  cycle re-projects;
* the coarsest solve applies the dense pseudo-inverse, whose minimal-norm
  solution is the mean-zero representative.

The transfers are the torus variational pair: bilinear prolongation by 2x
replication and averaging rolls, and its adjoint R = P^T, separable full
weighting with wrap-around.  The solution is reported in its mean-zero
gauge.  Each function computes what its namesake in ``tpu_multigrid.
problems.periodic`` computes, in the same order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Union

import numpy as np
import torch

from ..config import MultigridConfig, default_device
from ..core.grids import Hierarchy


class PeriodicOp:
    """Matrix-free 5-point Poisson operator on the (n, n) torus."""

    ndim = 2

    def __init__(self, n: int):
        self.n = int(n)

    @property
    def S(self):
        return self.n

    @property
    def grid_shape(self):
        return (self.n, self.n)

    @property
    def box(self):
        # every node is an unknown (grids.coarse_solve)
        return (0, self.n - 1, 0, self.n - 1)

    @staticmethod
    def _nbr(u):
        return (torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
                + torch.roll(u, 1, -1) + torch.roll(u, -1, -1))

    def apply(self, u):
        return 4.0 * u - self._nbr(u)

    def residual(self, u, b):
        return b - 4.0 * u + self._nbr(u)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        """Weighted Jacobi (``omega`` a float, or a tuple of per-sweep
        weights, cycled) or red-black Gauss-Seidel, red (``(i + j) % 2 ==
        0``) first."""
        if sweeps <= 0:
            return u
        if smoother == "jacobi":
            ws = omega if isinstance(omega, tuple) else (omega,)
            v = u
            for s in range(sweeps):
                w = ws[s % len(ws)]
                v = (1.0 - w) * v + (0.25 * w) * (b + self._nbr(v))
            return v
        if smoother == "rbgs":
            i = torch.arange(self.n, device=u.device)
            parity = (i[:, None] + i[None, :]) % 2
            v = u
            for _ in range(sweeps):
                for color in (0, 1):
                    v = torch.where(parity == color,
                                    0.25 * (b + self._nbr(v)), v)
            return v
        raise ValueError(f"unknown smoother {smoother!r}")

    # -- cycle transfer protocol (the coarse op owns the pair) --

    def restrict_into(self, r, fine_op):
        """R = P^T on the torus: separable full weighting with wrap, then
        the even rows and columns."""
        t = r + 0.5 * (torch.roll(r, 1, -1) + torch.roll(r, -1, -1))
        t = t + 0.5 * (torch.roll(t, 1, -2) + torch.roll(t, -1, -2))
        return t[..., 0::2, 0::2]

    def prolong_add_into(self, u, ec, fine_op):
        """u + P ec: 2x replication, then averaging rolls (wrap =
        periodic)."""
        e = ec.repeat_interleave(2, -2).repeat_interleave(2, -1)
        e = 0.5 * (e + torch.roll(e, -1, -2))
        e = 0.5 * (e + torch.roll(e, -1, -1))
        return u + e

    def __repr__(self):
        return f"PeriodicOp(n={self.n})"


@functools.lru_cache(maxsize=4)
def _pinv(n: int) -> np.ndarray:
    """The float64 pseudo-inverse of the n^2-node torus operator, computed
    once per n in a process (a dense SVD: seconds at n = 32)."""
    m = n * n
    idx = np.arange(m).reshape(n, n)
    a = np.zeros((m, m))
    a[np.arange(m), np.arange(m)] = 4.0
    for ax, d in ((0, 1), (0, -1), (1, 1), (1, -1)):
        nb = np.roll(idx, d, axis=ax)
        a[idx.ravel(), nb.ravel()] -= 1.0
    inv = np.linalg.pinv(a)
    inv.setflags(write=False)
    return inv


def periodic_coarse_pinv(n: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Dense pseudo-inverse of the n^2-node torus operator, computed in
    float64 numpy and stored in ``dtype``.  The minimal-norm least-squares
    solution is the mean-zero representative, the gauge the solver
    reports."""
    return torch.tensor(_pinv(n), dtype=dtype, device=device)


def build_periodic_hierarchy(config: MultigridConfig,
                             device=None) -> Hierarchy:
    levels = tuple(PeriodicOp(2 ** l)
                   for l in range(config.finest_level,
                                  config.coarsest_level - 1, -1))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = periodic_coarse_pinv(levels[-1].n, device=device)
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class PeriodicPoissonProblem:
    """-lap(u) = forcing on the unit torus (solution in the mean-zero
    gauge), on ``device`` (the card when None).

    ``forcing`` is a callable ``f(x, y)`` on torch tensors, compatible
    (zero mean); the right-hand side projects the mean out exactly, so a
    mildly incompatible quadrature is absorbed rather than amplified.  A
    constant forcing raises.
    """

    config: MultigridConfig
    forcing: Union[float, Callable] = None
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if not callable(self.forcing):
            raise ValueError("periodic problems need a (zero-mean) "
                             "callable forcing; a nonzero constant f is "
                             "incompatible on the torus")
        self.device = default_device(self.device)
        self.hierarchy: Hierarchy = build_periodic_hierarchy(
            self.config, device=self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> torch.Tensor:
        n = self.finest.n
        dt = dtype if dtype is not None else self.config.dtype
        h = 1.0 / n
        c = torch.arange(n, dtype=dt, device=self.device) * h
        x = c[None, :].expand(n, n)
        y = c[:, None].expand(n, n)
        vals = self.forcing(x, y).to(dt) * (h * h)
        return vals - torch.mean(vals)
