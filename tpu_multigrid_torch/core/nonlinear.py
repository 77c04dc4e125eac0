"""Nonlinear level operators for the FAS (Full Approximation Scheme) tier.

The counterpart of ``tpu_multigrid.core.nonlinear``, in torch:

* :class:`PointwiseNonlinearOp`: N(u) = A u + h² φ(u), with A a linear
  stencil operator and φ a pointwise nonlinearity (Bratu's −λ eᵘ, cubic
  reactions λu³, ...).  The Jacobian is A + h² diag(φ′(u)), so Jacobi–Newton
  smoothing costs one extra pointwise evaluation per sweep, and the coarsest
  level admits an exact Newton solve on the dense A.
* :class:`QuasilinearFluxOp` / :class:`QuasilinearFluxOp3`: N(u) =
  Σ_edges a(ū_e)(u − u_nbr) for a solution-dependent diffusion coefficient
  a(u), matrix-free; Picard–Jacobi smoothing with the frozen-coefficient
  diagonal.

Each method evaluates the JAX package's jnp operations in their order, so
float64 results agree with it to roundoff.  Neighbours come from
``torch.roll``: wrapped values land only on nodes the interior mask zeroes.

The CUDA kernels of the tier (``kernels.fas``, ``kernels.fas3d``) are built
once by nvcc and cannot take an arbitrary Python callable, as the Pallas
kernels do when they trace one.  They carry a closed set of
nonlinearities, each a small callable class here that computes exactly the
JAX package's lambda on tensors and also names its kernel selector and its
scalar: :class:`BratuNonlinearity` (φ(u) = −λ eᵘ, its own derivative) and
:class:`QuadraticCoefficient` (a(u) = 1 + γu²).  A caller's own callable
runs the plain path.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import ops, ops3d
from .grids import dense_poisson_matrix

__all__ = ["BratuNonlinearity", "QuadraticCoefficient", "kernel_selector",
           "op_selector", "PointwiseNonlinearOp", "QuasilinearFluxOp",
           "QuasilinearFluxOp3", "inject_solution", "inject_solution3",
           "dense_poisson_matrix"]

# Kernel selectors of the carried nonlinearities (csrc/fasnl.cuh).
KIND_BRATU = 1
KIND_QUADRATIC = 2
CARRIED = ("BratuNonlinearity (phi = -lam exp(u), with dphi the same "
           "object) and QuadraticCoefficient (a = 1 + gamma u^2)")


class BratuNonlinearity:
    """φ(u) = −λ eᵘ, the Bratu nonlinearity; φ′ = φ, so a problem passes
    the same object as ``phi`` and ``dphi`` and Jacobi–Newton evaluates the
    exponential once per sweep.  ``kind`` and ``scalar`` (λ) select it in
    the FAS kernels."""

    kind = KIND_BRATU

    def __init__(self, lam: float):
        self.lam = float(lam)

    @property
    def scalar(self) -> float:
        return self.lam

    def __call__(self, u):
        return -self.lam * torch.exp(u)

    def __repr__(self):
        return f"BratuNonlinearity(lam={self.lam})"


class QuadraticCoefficient:
    """a(u) = 1 + γu², the quasilinear problems' default diffusion
    coefficient; ``da`` is its derivative (reporting only).  ``kind`` and
    ``scalar`` (γ) select it in the FAS kernels."""

    kind = KIND_QUADRATIC

    def __init__(self, gamma: float):
        self.gamma = g = float(gamma)
        self.da = lambda u: 2.0 * g * u

    @property
    def scalar(self) -> float:
        return self.gamma

    def __call__(self, u):
        return 1.0 + self.gamma * u * u

    def __repr__(self):
        return f"QuadraticCoefficient(gamma={self.gamma})"


def kernel_selector(f, df=None) -> Optional[tuple]:
    """(kind, scalar) that the FAS kernels take for a nonlinearity, or None
    for a caller's own callable, which only the plain path runs: φ a
    :class:`BratuNonlinearity` with φ′ that same object, or a diffusion
    coefficient a :class:`QuadraticCoefficient` (``df`` None)."""
    if (isinstance(f, BratuNonlinearity) and df is f
            or isinstance(f, QuadraticCoefficient) and df is None):
        return f.kind, f.scalar
    return None


def op_selector(op) -> Optional[tuple]:
    """:func:`kernel_selector` of a nonlinear operator's nonlinearity."""
    if isinstance(op, PointwiseNonlinearOp):
        return kernel_selector(op.phi, op.dphi)
    return kernel_selector(op.a)


class PointwiseNonlinearOp:
    """N(u) = A u + h² φ(u) on the interior of a padded 2D or 3D grid.

    ``lin`` is a linear stencil operator with ``apply``/``S``/``n``
    (``ConstStencilOp`` or ``ConstStencilOp3D``); ``phi``/``dphi`` are
    pointwise callables on tensors.  ``diag`` is the linear operator's
    diagonal.  ``a_dense`` (coarsest level only, a tensor) enables the
    exact Newton coarse solve."""

    def __init__(self, lin, phi: Callable, dphi: Callable,
                 diag: float = 4.0, a_dense: Optional[torch.Tensor] = None):
        self.lin = lin
        self.phi = phi
        self.dphi = dphi
        self.diag = float(diag)
        self.a_dense = a_dense

    @property
    def n(self) -> int:
        return self.lin.n

    @property
    def S(self) -> int:
        return self.lin.S

    @property
    def ndim(self) -> int:
        return getattr(self.lin, "ndim", 2)

    @property
    def grid_shape(self):
        return getattr(self.lin, "grid_shape", (self.lin.S, self.lin.S))

    @property
    def h2(self) -> float:
        return (1.0 / self.lin.n) ** 2

    def to(self, device) -> "PointwiseNonlinearOp":
        """The operator with ``a_dense`` on ``device``."""
        a = None if self.a_dense is None else self.a_dense.to(device)
        return PointwiseNonlinearOp(self.lin, self.phi, self.dphi, self.diag,
                                    a)

    def _mask(self, x):
        if self.ndim == 3:
            return ops3d.mask_interior3(x, self.n)
        return ops.mask_interior(x, self.n)

    def apply(self, u):
        nl = self.h2 * self.phi(u).to(u.dtype)
        return self.lin.apply(u) + self._mask(nl)

    def residual(self, u, b):
        return b - self.apply(u)

    def nsmooth(self, u, b, *, omega: float, sweeps: int):
        """Jacobi–Newton relaxation: one pointwise Newton update per node,
        damped by ``omega``.  When ``dphi is phi`` (Bratu) the
        nonlinearity is evaluated once per sweep."""
        if sweeps <= 0:
            return u
        h2 = self.h2
        v = u
        for _ in range(sweeps):
            pv = self.phi(v).to(v.dtype)
            dv = pv if self.dphi is self.phi else self.dphi(v).to(v.dtype)
            r = b - (self.lin.apply(v) + self._mask(h2 * pv))
            denom = self.diag + h2 * dv
            upd = omega * r / denom
            v = v + self._mask(upd)
        return v

    def coarse_newton(self, u, b, steps: int = 3):
        """Exact-Jacobian Newton at the coarsest level: J = A + h²φ′(u),
        dense, from the precomputed interior A, solved with
        ``torch.linalg.solve_ex``: ``solve``'s check of the factorisation
        would make the host wait for the card at every step, three times a
        cycle.  A singular J gives non-finite values, as ``jnp.linalg.solve``
        does in the JAX package, and the drivers' norms carry them."""
        if self.a_dense is None:
            raise ValueError("coarse_newton needs a_dense (coarsest level)")
        n = self.n
        m1 = n - 1
        h2 = self.h2
        A = self.a_dense.to(u.dtype)
        inter = (slice(1, n),) * self.ndim
        eshape = (m1,) * self.ndim
        v = u
        for _ in range(steps):
            rv = self.residual(v, b)[inter].reshape(-1)
            dd = (h2 * self.dphi(v).to(v.dtype))[inter].reshape(-1)
            J = A + torch.diag(dd)
            ev = torch.linalg.solve_ex(J, rv)[0]
            v = v.clone()
            v[inter] += ev.reshape(eshape)
        return v

    def __repr__(self):
        return f"PointwiseNonlinearOp(n={self.n}, S={self.S})"


def _shift(u, di, dj):
    """Wraparound shift: result[i, j] = u[i+di, j+dj] (a roll; safe only
    for |d| = 1 under the zero-padding invariant with an interior-masked
    result)."""
    return torch.roll(u, (-di, -dj), (-2, -1))


_EDGES2 = ((0, 1), (0, -1), (1, 0), (-1, 0))


class QuasilinearFluxOp:
    """Matrix-free quasilinear diffusion: N(u) = Σ_e a(ū_e)(u − u_nbr), the
    coefficient evaluated at edge midpoints ū_e = (u_i + u_j)/2, in the
    h-independent scaling (the right-hand side carries h²).  Carries no
    array state: each level re-discretizes."""

    def __init__(self, n: int, S: int, a: Callable, da: Callable):
        self.n = int(n)
        self.S = int(S)
        self.a = a
        self.da = da

    @property
    def h2(self) -> float:
        return (1.0 / self.n) ** 2

    def _edge_fluxes(self, u):
        out = torch.zeros_like(u)
        for di, dj in _EDGES2:
            un = _shift(u, di, dj)
            ae = self.a(0.5 * (u + un)).to(u.dtype)
            out = out + ae * (u - un)
        return out

    def apply(self, u):
        return ops.mask_interior(self._edge_fluxes(u), self.n)

    def residual(self, u, b):
        return b - self.apply(u)

    def _frozen_diag(self, u):
        """Picard diagonal: Σ_e a(ū_e) with coefficients frozen at u."""
        d = torch.zeros_like(u)
        for di, dj in _EDGES2:
            un = _shift(u, di, dj)
            d = d + self.a(0.5 * (u + un)).to(u.dtype)
        return d

    def nsmooth(self, u, b, *, omega: float, sweeps: int):
        """Picard–Jacobi: a Jacobi step on the frozen-coefficient operator,
        the diagonal guarded by ``where(d > 0, d, 1)``."""
        v = u
        for _ in range(max(sweeps, 0)):
            r = self.residual(v, b)
            denom = self._frozen_diag(v)
            safe = torch.where(denom > 0, denom, 1.0)
            v = v + ops.mask_interior(omega * r / safe, self.n)
        return v

    def __repr__(self):
        return f"QuasilinearFluxOp(n={self.n}, S={self.S})"


# (d, axis) of the six edges, in QuasilinearFluxOp3's accumulation order.
_EDGES3 = tuple((d, ax) for ax in (0, 1, 2) for d in (1, -1))


class QuasilinearFluxOp3:
    """3D matrix-free quasilinear diffusion on an (S, S, Sx) grid: six edge
    fluxes with coefficients at solution midpoints (the unit-cube analogue
    of :class:`QuasilinearFluxOp`)."""

    ndim = 3

    def __init__(self, n: int, S: int, a: Callable, da: Callable,
                 Sx: int = None):
        self.n = int(n)
        self.S = int(S)
        self.a = a
        self.da = da
        self.Sx = int(Sx) if Sx is not None else int(S)

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    @property
    def h2(self) -> float:
        return (1.0 / self.n) ** 2

    def _mask(self, x):
        return ops3d.mask_interior3(x, self.n)

    def apply(self, u):
        out = torch.zeros_like(u)
        for d, ax in _EDGES3:
            un = torch.roll(u, -d, ax - 3)
            ae = self.a(0.5 * (u + un)).to(u.dtype)
            out = out + ae * (u - un)
        return self._mask(out)

    def residual(self, u, b):
        return b - self.apply(u)

    def _frozen_diag(self, u):
        d0 = torch.zeros_like(u)
        for d, ax in _EDGES3:
            un = torch.roll(u, -d, ax - 3)
            d0 = d0 + self.a(0.5 * (u + un)).to(u.dtype)
        return d0

    def nsmooth(self, u, b, *, omega: float, sweeps: int):
        """Picard–Jacobi (see :meth:`QuasilinearFluxOp.nsmooth`)."""
        v = u
        for _ in range(max(sweeps, 0)):
            r = self.residual(v, b)
            denom = self._frozen_diag(v)
            safe = torch.where(denom > 0, denom, 1.0)
            v = v + self._mask(omega * r / safe)
        return v

    def __repr__(self):
        return f"QuasilinearFluxOp3(n={self.n}, S={self.S})"


def inject_solution(u: torch.Tensor, nf: int, Sc: int) -> torch.Tensor:
    """Literal (unscaled) injection of a solution grid to the coarse level:
    coarse[i, j] = fine[2i, 2j], masked to the coarse interior.  FAS
    restricts the solution as well as the residual, and solution values
    transfer verbatim (unlike ``ops.restrict_injection``'s ×4)."""
    c = ops._crop_pad_square(u[..., ::2, ::2], Sc)
    return ops.mask_interior(c, nf // 2)


def inject_solution3(u: torch.Tensor, nf: int, Sc) -> torch.Tensor:
    """3D literal solution injection: coarse[i, j, k] = fine[2i, 2j, 2k],
    cropped or padded to ``Sc`` and masked to the coarse interior."""
    shc = ops3d._shape3(Sc)
    t = u[..., ::2, ::2, ::2]
    return ops3d.mask_interior3(ops3d._crop_pad3(t, shc), nf // 2)
