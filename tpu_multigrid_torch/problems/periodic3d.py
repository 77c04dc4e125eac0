"""Periodic Poisson on the unit 3-torus: -lap(u) = f, all axes periodic.

The 3D twin of :mod:`.periodic`: grids are (n, n, n) arrays of the unique
torus nodes (node n is node 0), ``torch.roll``'s wrap is the topology (no
masks anywhere), the operator has the constants as its null space, and the
coarsest solve applies a dense pseudo-inverse, whose minimal-norm solution
is the mean-zero gauge.  The transfers are the torus variational pair per
axis (replication and averaging rolls, separable full weighting with wrap)
through the operator transfer protocol (``restrict_into`` /
``prolong_add_into``).  Each function computes what its namesake in
``tpu_multigrid.problems.periodic3d`` computes, in the same order.  No
kernel takes this operator.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Union

import numpy as np
import torch

from ..config import MultigridConfig, default_device
from ..core.grids import Hierarchy


class PeriodicOp3:
    """Matrix-free 7-point Poisson operator on the (n, n, n) torus."""

    ndim = 3

    def __init__(self, n: int):
        self.n = int(n)

    @property
    def S(self):
        return self.n

    @property
    def grid_shape(self):
        return (self.n, self.n, self.n)

    @property
    def unknown_slices(self):
        # every torus node is an unknown (grids.coarse_solve)
        return (slice(0, self.n),) * 3

    @staticmethod
    def _nbr(u):
        return (torch.roll(u, 1, -3) + torch.roll(u, -1, -3)
                + torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
                + torch.roll(u, 1, -1) + torch.roll(u, -1, -1))

    def apply(self, u):
        return 6.0 * u - self._nbr(u)

    def residual(self, u, b):
        return b - 6.0 * u + self._nbr(u)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        """Weighted Jacobi (a float or per-sweep tuple ``omega``) or red-
        black Gauss-Seidel, red (``(i + j + k) % 2 == 0``) first."""
        if sweeps <= 0:
            return u
        if smoother == "jacobi":
            ws = omega if isinstance(omega, tuple) else (omega,)
            sixth = 1.0 / 6.0
            v = u
            for s in range(sweeps):
                w = ws[s % len(ws)]
                v = (1.0 - w) * v + (sixth * w) * (b + self._nbr(v))
            return v
        if smoother == "rbgs":
            i = torch.arange(self.n, device=u.device)
            parity = (i[:, None, None] + i[None, :, None]
                      + i[None, None, :]) % 2
            v = u
            for _ in range(sweeps):
                for color in (0, 1):
                    v = torch.where(parity == color,
                                    (1.0 / 6.0) * (b + self._nbr(v)), v)
            return v
        raise ValueError(f"unknown smoother {smoother!r}")

    # -- transfer protocol: the per-axis torus pair --

    def restrict_into(self, r, fine_op):
        """R = P^T / 2 on the torus: separable [1/2, 1, 1/2] blurs with
        wrap, then the even nodes.  The extra 1/2 is the 3D variational
        scaling: the h-independent 7-point stencil scales linearly with h
        in 3D, so R A P with R = P^T would be twice the re-discretized
        coarse operator."""
        t = r
        for ax in (-3, -2, -1):
            t = t + 0.5 * (torch.roll(t, 1, ax) + torch.roll(t, -1, ax))
        return 0.5 * t[..., 0::2, 0::2, 0::2]

    def prolong_add_into(self, u, ec, fine_op):
        e = ec
        for ax in (-3, -2, -1):
            e = e.repeat_interleave(2, ax)
        for ax in (-3, -2, -1):
            e = 0.5 * (e + torch.roll(e, -1, ax))
        return u + e

    def __repr__(self):
        return f"PeriodicOp3(n={self.n})"


@functools.lru_cache(maxsize=4)
def _pinv3(n: int) -> np.ndarray:
    """The float64 pseudo-inverse of the n^3-node torus operator, computed
    once per n in a process."""
    m = n ** 3
    idx = np.arange(m).reshape(n, n, n)
    a = np.zeros((m, m))
    a[np.arange(m), np.arange(m)] = 6.0
    for ax in (0, 1, 2):
        for d in (1, -1):
            nb = np.roll(idx, d, axis=ax)
            a[idx.ravel(), nb.ravel()] -= 1.0
    inv = np.linalg.pinv(a)
    inv.setflags(write=False)
    return inv


def periodic3_coarse_pinv(n: int, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """Dense pseudo-inverse of the n^3-node torus operator (mean-zero
    gauge), computed in float64 numpy and stored in ``dtype``."""
    return torch.tensor(_pinv3(n), dtype=dtype, device=device)


def build_periodic3_hierarchy(config: MultigridConfig,
                              device=None) -> Hierarchy:
    levels = tuple(PeriodicOp3(2 ** l)
                   for l in range(config.finest_level,
                                  config.coarsest_level - 1, -1))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = periodic3_coarse_pinv(levels[-1].n, device=device)
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class Periodic3DPoissonProblem:
    """-lap(u) = forcing on the unit 3-torus (mean-zero gauge), on
    ``device`` (the card when None).  ``forcing`` is a callable
    ``f(x, y, z)`` on torch tensors; a constant forcing raises."""

    config: MultigridConfig
    forcing: Union[Callable, None] = None
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if not callable(self.forcing):
            raise ValueError("periodic problems need a (zero-mean) "
                             "callable forcing")
        self.device = default_device(self.device)
        self.hierarchy: Hierarchy = build_periodic3_hierarchy(
            self.config, device=self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> torch.Tensor:
        n = self.finest.n
        dt = dtype if dtype is not None else self.config.dtype
        h = 1.0 / n
        c = torch.arange(n, dtype=dt, device=self.device) * h
        x = c[None, None, :]
        y = c[None, :, None]
        z = c[:, None, None]
        vals = torch.broadcast_to(self.forcing(x, y, z),
                                  (n, n, n)).to(dt) * (h * h)
        return vals - torch.mean(vals)
