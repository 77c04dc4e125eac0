"""Variable-coefficient diffusion -div(a(x) grad u) = f on the unit square,
Dirichlet boundaries.

Per-cell coefficients define the fine 5-point flux stencil; the coarse
operators are its Galerkin products R A P, 9-point stencils, built once at
set-up on the host (``core.operators.galerkin_coarsen_host``) and put on
the device in one upload.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ..config import MultigridConfig, default_device
from ..core.grids import Hierarchy, build_galerkin_hierarchy, level_sizes
from ..core.operators import diffusion_op_host
from .poisson import poisson_rhs


def cell_coefficients(n: int, a: Union[float, Callable],
                      dtype=torch.float32) -> torch.Tensor:
    """(n, n) per-cell coefficients as a CPU tensor: a callable ``a(x, y)``
    is evaluated on torch tensors at the cell centres, in ``dtype``."""
    if callable(a):
        c = (torch.arange(n, dtype=dtype) + 0.5) * (1.0 / n)
        x = c[None, :].expand(n, n)
        y = c[:, None].expand(n, n)
        return torch.as_tensor(a(x, y)).to(dtype).expand(n, n)
    return torch.full((n, n), float(a), dtype=dtype)


def upload(hier: Hierarchy, config: MultigridConfig, device) -> Hierarchy:
    """Put a host-built variable-coefficient hierarchy on ``device`` in one
    upload, with the kernels' coefficient planes built first when the config
    takes the kernels."""
    if config.use_kernels:
        for op in hier.levels:
            op.with_sym_planes()
    return hier.to(device)


@dataclasses.dataclass
class DiffusionProblem:
    """Variable-coefficient diffusion with a Galerkin-coarsened hierarchy,
    on ``device`` (the card when None; see ``config.default_device``)."""

    config: MultigridConfig
    coefficient: Union[float, Callable] = 1.0
    forcing: Union[float, Callable] = 4.0
    align: int = 1
    min_pad_level: int = 99
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = default_device(self.device)
        sizes = level_sizes(self.config, align=self.align,
                            min_pad_level=self.min_pad_level)
        n0, S0 = sizes[0]
        cells = cell_coefficients(n0, self.coefficient,
                                  self.config.dtype).numpy()
        hier = build_galerkin_hierarchy(
            diffusion_op_host(cells, n0, S0), self.config, align=self.align,
            min_pad_level=self.min_pad_level)
        self.hierarchy: Hierarchy = upload(hier, self.config, self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> torch.Tensor:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson_rhs(op.n, op.S, self.forcing, dt, self.device)
