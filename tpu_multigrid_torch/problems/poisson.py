"""2D Poisson problem on the unit square, Dirichlet BCs.

-lap(u) = f with P1 elements on a structured grid: the load vector is the
closed form b = f * h^2 at every interior node.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ..config import MultigridConfig, default_device
from ..core import ops
from ..core.grids import Hierarchy, build_poisson_hierarchy, node_coordinates


def poisson_rhs(n: int, S: int, f: Union[float, Callable] = 4.0,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """FEM load vector as a padded (S, S) grid: b = f(x, y) * h^2, interior.

    ``f`` is a constant forcing or a callable ``f(x, y)`` evaluated at the
    nodes on torch tensors.
    """
    h2 = (1.0 / n) ** 2
    if callable(f):
        x, y = node_coordinates(n, S, dtype, device)
        vals = f(x, y).to(dtype) * h2
    else:
        vals = torch.full((S, S), float(f) * h2, dtype=dtype, device=device)
    return ops.mask_interior(vals, n)


def boundary_grid(n: int, S: int, g: Union[float, Callable],
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """(S, S) grid holding the Dirichlet boundary values ``g`` on the
    physical boundary nodes (i or j in {0, n}) and zeros elsewhere, for
    lifting: ``u = w + G`` with ``w`` solving ``A w = b - A G``."""
    if callable(g):
        x, y = node_coordinates(n, S, dtype, device)
        vals = g(x, y).to(dtype)
    else:
        vals = torch.full((S, S), float(g), dtype=dtype, device=device)
    i = torch.arange(S, device=device)
    on_edge = (i == 0) | (i == n)
    in_range = i <= n
    m = ((on_edge[:, None] & in_range[None, :])
         | (in_range[:, None] & on_edge[None, :]))
    return torch.where(m, vals, 0.0)


@dataclasses.dataclass
class PoissonProblem:
    """Front-door problem object: hierarchy + per-level RHS assembly, on
    ``device`` (the card when None; see ``config.default_device``)."""

    config: MultigridConfig
    forcing: Union[float, Callable] = 4.0
    align: int = 1
    min_pad_level: int = 99
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = default_device(self.device)
        self.hierarchy: Hierarchy = build_poisson_hierarchy(
            self.config, align=self.align, min_pad_level=self.min_pad_level,
            device=self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> torch.Tensor:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson_rhs(op.n, op.S, self.forcing, dt, self.device)

    def rhs_all_levels(self, dtype=None):
        """Per-level assembled RHS (for ``fmg_rhs="assemble"``)."""
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]
