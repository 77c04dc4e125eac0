"""Pieces of the distributed FAS tier: the rank-local nonlinear operator
and the replicated coarse hierarchy.

The pointwise nonlinear Poisson operator N(u) = A u + h² φ(u) on a rank's
block (:func:`_n_apply_local`, :func:`_n_residual_local`; one ghost ring
through :mod:`.local_ops`), and :func:`build_replicated_tail`, the
``PointwiseNonlinearOp`` hierarchy over every level size whose replicated
tail the fused FAS tier (:mod:`.fas_pallas`) runs below its switch, ending
in the dense Newton coarsest solve.

The part of ``tpu_multigrid/dist/fas.py`` that the fused FAS tier reads,
with the :class:`.mesh.GridMesh` passed explicitly.  ``fas_sharded_solve``,
the plain shard-local FAS tier behind ``dist_path="jnp"``, is not ported
yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import MultigridConfig
from ..core.grids import Hierarchy, dense_poisson_matrix
from ..core.nonlinear import PointwiseNonlinearOp
from ..core.operators import poisson_op
from . import local_ops as L
from .mesh import GridMesh
from .shard_cycle import ShardedLevels


def _n_apply_local(mesh: GridMesh, u, phi, n: int, h2: float):
    """N(u) = 4u - Σnbr + h² φ(u), masked to the interior (local block)."""
    out = 4.0 * u - L.neighbor_sum_local(mesh, u)
    out = out + h2 * phi(u).to(u.dtype)
    return torch.where(L.interior_mask_local(mesh, u.shape, n, u.device), out,
                       0.0)


def _n_residual_local(mesh: GridMesh, u, b, phi, n: int, h2: float):
    """b - N(u), masked to the interior (local block)."""
    return torch.where(L.interior_mask_local(mesh, u.shape, n, u.device),
                       b - ((4.0 * u - L.neighbor_sum_local(mesh, u))
                            + h2 * phi(u).to(u.dtype)), 0.0)


def build_replicated_tail(levels: ShardedLevels, cfg: MultigridConfig,
                          phi: Callable, dphi: Callable,
                          device=None) -> Hierarchy:
    """``PointwiseNonlinearOp`` hierarchy over ALL level sizes (the sharded
    prefix is never touched through it, only the replicated tail), with the
    dense interior A on the coarsest level, on ``device``, when
    ``cfg.coarse_solver == "direct"``."""
    ops_ = []
    for idx, (n, S) in enumerate(levels.sizes):
        a_dense = None
        if idx == len(levels.sizes) - 1 and cfg.coarse_solver == "direct":
            a_dense = torch.as_tensor(dense_poisson_matrix(n),
                                      dtype=cfg.dtype, device=device)
        ops_.append(PointwiseNonlinearOp(poisson_op(n, S), phi, dphi,
                                         diag=4.0, a_dense=a_dense))
    return Hierarchy(tuple(ops_), None)
