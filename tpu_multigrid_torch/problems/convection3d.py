"""3D convection-diffusion -eps lap(u) + b . grad(u) = f on the unit cube,
first-order donor-cell upwinding (an M-matrix at any mesh Peclet number).

The operator is nonsymmetric, so :class:`Directional7Op` stores the six
directional couplings explicitly.  In the h-independent scaling (stencil
times h^2, right-hand side f h^2):

    diag = 6 eps + h (|bx| + |by| + |bz|)
    coupling to the -axis neighbour = eps + h max(b_axis, 0)  (donor)
    coupling to the +axis neighbour = eps + h max(-b_axis, 0)

Every level re-discretizes with its own h.  Constant winds make each
level's stencil constant: the operator carries ``STENCIL27`` and rides the
static-stencil kernels K1_3 / K2_3.  Callable winds store one (6, S, S, Sx)
stack [cp_z, cp_y, cp_x, cm_z, cm_y, cm_x], which K1v_3 / K2v_3 stream.
The arrays are built on the host in numpy, in the JAX package's
arithmetic, and put on the device in one upload.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from ..config import MultigridConfig, default_device
from ..core import ops3d
from ..core.grids import (Hierarchy, coarse_dense_inverse, level_sizes,
                          round_up)
from ..core.operators import _put, smooth_flux3
from .diffusion3d import _np_dtype, axis_coordinates3, eval3
from .poisson3d import poisson3d_rhs


class Directional7Op:
    """Nonsymmetric 7-point operator with explicit directional planes:
    ``cp[ax]`` couples node (i, j, k) to its +axis neighbour, ``cm[ax]`` to
    its -axis one (ax 0 = z, 1 = y, 2 = x); ``(A u)[p] = diag[p] u[p] -
    sum_ax (cp u_+ + cm u_-)``.  With ``coef_stack`` (variable winds) cp and
    cm are views of its planes.  ``apply``, ``residual`` and ``smooth``
    evaluate the JAX package's ``Directional7Op`` in its order."""

    ndim = 3

    def __init__(self, cp, cm, diag, inv_diag, n: int, S: int, Sx: int,
                 stencil27=None, coef_stack=None):
        self._cp = tuple(cp) if cp is not None else None
        self._cm = tuple(cm) if cm is not None else None
        self.coef_stack = coef_stack
        self.diag = diag
        self.inv_diag = inv_diag
        self.n = int(n)
        self.S = int(S)
        self.Sx = int(Sx)
        self.STENCIL27 = stencil27

    @property
    def cp(self):
        if self._cp is not None:
            return self._cp
        return tuple(self.coef_stack[k] for k in range(3))

    @property
    def cm(self):
        if self._cm is not None:
            return self._cm
        return tuple(self.coef_stack[k] for k in range(3, 6))

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    def to(self, device) -> "Directional7Op":
        """The operator with every array as a tensor on ``device``."""
        def put_all(planes):
            return None if planes is None else [_put(a, device)
                                                for a in planes]
        return Directional7Op(put_all(self._cp), put_all(self._cm),
                              _put(self.diag, device),
                              _put(self.inv_diag, device), self.n, self.S,
                              self.Sx, stencil27=self.STENCIL27,
                              coef_stack=_put(self.coef_stack, device))

    def _off_diag_apply(self, u):
        acc = torch.zeros_like(u)
        cp, cm = self.cp, self.cm
        for ax in (0, 1, 2):
            a = ax - 3
            acc = acc + (cp[ax] * torch.roll(u, -1, a)
                         + cm[ax] * torch.roll(u, 1, a))
        return acc.to(u.dtype)

    def apply(self, u):
        out = self.diag.to(u.dtype) * u - self._off_diag_apply(u)
        return ops3d.mask_interior3(out.to(u.dtype), self.n)

    def residual(self, u, b):
        return ops3d.mask_interior3((b - self.apply(u)).to(u.dtype), self.n)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        return smooth_flux3(self, u, b, smoother, omega, sweeps)

    def __repr__(self):
        return f"Directional7Op(n={self.n}, S={self.S}, Sx={self.Sx})"


def _field3(v, n: int, shape) -> np.ndarray:
    """A wind (a constant or ``v(x, y, z)``) at the nodes, float64."""
    return eval3(v, shape, *axis_coordinates3(shape, n))


def convection_diffusion_op3(n: int, S: int, Sx: int, eps: float, bx, by, bz,
                             dtype=np.float32) -> Directional7Op:
    """The upwind 7-point stencil of -eps lap(u) + b . grad(u), h = 1/n."""
    h = 1.0 / n
    shape = (S, S, Sx)
    winds = [_field3(v, n, shape) for v in (bz, by, bx)]   # z, y, x
    cp, cm = [], []
    absum = np.zeros(shape, np.float64)
    for B in winds:
        bp, bm = np.maximum(B, 0.0), np.maximum(-B, 0.0)
        cm.append(eps + h * bp)       # -axis neighbour: donor when b > 0
        cp.append(eps + h * bm)       # +axis neighbour: donor when b < 0
        absum += bp + bm
    diag = 6.0 * eps + h * absum
    inter = np.zeros(shape, bool)
    inter[1:n, 1:n, 1:n] = True
    dt = np.dtype(dtype)
    # Constant winds: static weights, stencil27[dz+1][dy+1][dx+1]
    # multiplying u[i+dz, j+dy, k+dx], the face weights -cp / -cm.
    st27 = None
    if not any(callable(v) for v in (bx, by, bz)):
        w = [[[0.0] * 3 for _ in range(3)] for _ in range(3)]
        w[1][1][1] = float(diag.reshape(-1)[0])
        for ax in range(3):
            idx_p, idx_m = [1, 1, 1], [1, 1, 1]
            idx_p[ax] += 1
            idx_m[ax] -= 1
            w[idx_p[0]][idx_p[1]][idx_p[2]] = -float(cp[ax].reshape(-1)[0])
            w[idx_m[0]][idx_m[1]][idx_m[2]] = -float(cm[ax].reshape(-1)[0])
        st27 = tuple(tuple(tuple(r) for r in p) for p in w)
    cp = [np.where(inter, c, 0.0).astype(dt) for c in cp]
    cm = [np.where(inter, c, 0.0).astype(dt) for c in cm]
    diag_m = np.where(inter, diag, 0.0).astype(dt)
    inv_diag = np.zeros(shape, np.float64)
    inv_diag[inter] = 1.0 / diag[inter]
    if st27 is None:
        return Directional7Op(None, None, diag_m, inv_diag.astype(dt), n, S,
                              Sx, coef_stack=np.stack(cp + cm))
    return Directional7Op(cp, cm, diag_m, inv_diag.astype(dt), n, S, Sx,
                          stencil27=st27)


def build_convection3d_hierarchy(config: MultigridConfig, eps, bx, by, bz, *,
                                 align: int = 1, min_pad_level: int = 99,
                                 lane_align: int = 1) -> Hierarchy:
    """The per-level re-discretized upwind hierarchy on the host; the
    kernels take ``align=16, min_pad_level=0, lane_align=128``."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    dt = _np_dtype(config.dtype)
    levels = []
    for n, S in sizes:
        Sx = round_up(n + 1, lane_align) if lane_align > 1 else S
        levels.append(convection_diffusion_op3(n, S, Sx, eps, bx, by, bz,
                                               dtype=dt))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


@dataclasses.dataclass
class ConvectionDiffusion3DProblem:
    """-eps lap(u) + b . grad(u) = forcing on the unit cube, on ``device``
    (the card when None)."""

    config: MultigridConfig
    eps: float = 1.0
    bx: Union[float, Callable] = 0.0
    by: Union[float, Callable] = 0.0
    bz: Union[float, Callable] = 0.0
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = default_device(self.device)
        hier = build_convection3d_hierarchy(
            self.config, self.eps, self.bx, self.by, self.bz,
            align=self.align, min_pad_level=self.min_pad_level,
            lane_align=self.lane_align)
        self.hierarchy: Hierarchy = hier.to(self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> torch.Tensor:
        op = self.finest
        dt = dtype if dtype is not None else self.config.dtype
        return poisson3d_rhs(op.n, op.grid_shape, self.forcing, dt,
                             self.device)
