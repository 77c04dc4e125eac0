"""System: the port's Poisson problem classes on homogeneous Dirichlet
boundaries, built as the front doors build them for the kernels.

The configuration gives the problem class (``problem.class``, a dotted
name in the port), its padding arguments (``problem.kwargs``) and the
``multigrid`` schedule (the fields of ``MultigridConfig``).

The scaling from the forcing f to the right-hand side b is the port's rule,
frozen here (``tpu_multigrid_torch/problems/poisson.py`` lines 19-32 and
``problems/poisson3d.py`` lines 60-70): b = f(x) h^2 at the interior nodes
(1 <= i <= n-1 on every axis, x_i = i h, h = 1/n), zero on the boundary and
in the padding.
"""

from __future__ import annotations

import importlib

import torch


def build(config: dict, device):
    """(hierarchy, MultigridConfig) of the program, built by its problem
    class."""
    import tpu_multigrid_torch as tmg
    fields = dict(config["multigrid"])
    fields["dtype"] = getattr(torch, fields["dtype"])
    cfg = tmg.MultigridConfig(**fields)
    module, cls = config["problem"]["class"].rsplit(".", 1)
    problem = getattr(importlib.import_module(module), cls)(
        cfg, device=device, **config["problem"]["kwargs"])
    return problem.hierarchy, cfg


def rhs(f: torch.Tensor, n: int) -> torch.Tensor:
    """b = f h^2 on the interior nodes of the padded grid ``f``, zero
    elsewhere (same type as ``f``)."""
    h = 1.0 / n
    b = f * (h * h)
    for ax, size in enumerate(f.shape):
        idx = torch.arange(size, device=f.device)
        inside = ((idx >= 1) & (idx <= n - 1)).reshape(
            [-1 if a == ax else 1 for a in range(f.ndim)])
        b = torch.where(inside, b, 0.0)
    return b
