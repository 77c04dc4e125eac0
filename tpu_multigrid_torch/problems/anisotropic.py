"""Anisotropic Poisson: -div(K grad u) = f on the unit square, Dirichlet
boundaries, with the constant tensor ``K = R(angle) diag(eps_x, eps_y)
R(angle)^T``.

Point smoothers degrade as the anisotropy grows; the robust configuration
on the fully coarsened hierarchy is zebra line relaxation along the strong
axis (``smoother="zebra_x"`` when eps_x >> eps_y; ``core.lines``) with
Galerkin coarse operators, built once on the host in numpy
(``core.operators.galerkin_coarsen_host``) and put on the device in one
upload.  Semi-coarsening (the JAX package's ``core.semicoarsen``) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from ..config import MultigridConfig, default_device
from ..core.grids import Hierarchy, build_galerkin_hierarchy, level_sizes
from ..core.operators import VarStencilOp
from .diffusion import upload
from .diffusion3d import _np_dtype
from .poisson import poisson_rhs


def anisotropic_poisson_op(n: int, S: int, eps_x: float = 1.0,
                           eps_y: float = 1.0, angle: float = 0.0,
                           dtype=np.float32) -> VarStencilOp:
    """h-independent stencil of ``-div(K grad u)``, in numpy on the host
    (the JAX package's arithmetic in its order, so the two agree bitwise).

    ``angle = 0`` is the axis-aligned 5-point stencil (diagonal
    ``2(eps_x + eps_y)``, E/W ``-eps_x``, N/S ``-eps_y``); ``angle != 0``
    adds the mixed derivative ``-2 K_xy u_xy`` by the centred four-corner
    stencil, the rotated anisotropy test problem.
    """
    ct, st = np.cos(angle), np.sin(angle)
    a = eps_x * ct * ct + eps_y * st * st         # K_xx
    bb = eps_x * st * st + eps_y * ct * ct        # K_yy
    c = (eps_x - eps_y) * st * ct                 # K_xy
    coef = np.zeros((3, 3, S, S), dtype)
    coef[1, 1] = 2.0 * (a + bb)
    coef[1, 0] = -a
    coef[1, 2] = -a
    coef[0, 1] = -bb
    coef[2, 1] = -bb
    # -2c u_xy: +-c/2 on the four corners; rows are the y index, so NE is
    # (i+1, j+1).
    coef[2, 2] += -0.5 * c
    coef[0, 0] += -0.5 * c
    coef[2, 0] += +0.5 * c
    coef[0, 2] += +0.5 * c
    i = np.arange(S)
    mrow = (i >= 1) & (i <= n - 1)
    m = mrow[:, None] & mrow[None, :]
    coef = np.where(m[None, None], coef, np.zeros((), dtype))
    diag = coef[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, 1.0), 0.0).astype(dtype)
    return VarStencilOp(coef, inv_diag, n, S)


def build_anisotropic_hierarchy(config: MultigridConfig, eps_x: float,
                                eps_y: float, angle: float = 0.0,
                                align: int = 1,
                                min_pad_level: int = 99) -> Hierarchy:
    """Galerkin hierarchy (R A P in closed form on the host); the levels
    hold numpy arrays until :meth:`Hierarchy.to`.  ``align`` /
    ``min_pad_level`` pad the levels (the zebra kernels take S a multiple
    of 128, K1z/K2z of 256)."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    fine = anisotropic_poisson_op(sizes[0][0], sizes[0][1], eps_x, eps_y,
                                  angle=angle, dtype=_np_dtype(config.dtype))
    return build_galerkin_hierarchy(fine, config, align=align,
                                    min_pad_level=min_pad_level)


@dataclasses.dataclass
class AnisotropicPoissonProblem:
    """-div(K grad u) = forcing, homogeneous Dirichlet boundaries, on
    ``device`` (the card when None; see ``config.default_device``).

    ``coarsening="full"`` is the standard hierarchy with Galerkin coarse
    operators: robust at strong anisotropy with ``smoother="zebra_x"``
    (eps_x >> eps_y) or ``"zebra_y"``.  ``coarsening="semi"`` raises
    ``NotImplementedError`` (not ported yet); with a rotation it raises
    ``ValueError`` first, as in the JAX package.
    """

    config: MultigridConfig
    eps_x: float = 1.0
    eps_y: float = 1.0
    forcing: Union[float, Callable] = 4.0
    coarsening: str = "full"
    angle: float = 0.0
    align: int = 1
    min_pad_level: int = 99
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if self.coarsening == "semi":
            if self.angle != 0.0:
                raise ValueError(
                    "axis-aligned semi-coarsening does not treat ROTATED "
                    "anisotropy (the strong direction is off-grid); use "
                    'coarsening="full" with zebra line smoothing')
            raise NotImplementedError('coarsening="semi" (semi-coarsened '
                                      "hierarchies) is not ported yet")
        if self.coarsening != "full":
            raise ValueError(f'coarsening must be "full" or "semi", got '
                             f"{self.coarsening!r}")
        self.device = default_device(self.device)
        hier = build_anisotropic_hierarchy(
            self.config, self.eps_x, self.eps_y, angle=self.angle,
            align=self.align, min_pad_level=self.min_pad_level)
        self.hierarchy: Hierarchy = upload(hier, self.config, self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> torch.Tensor:
        op = self.finest
        dt = dtype if dtype is not None else self.config.dtype
        return poisson_rhs(op.n, op.S, self.forcing, dt, self.device)
