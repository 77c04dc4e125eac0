"""System: the port's 3D variable-coefficient diffusion problem on
homogeneous Dirichlet boundaries, built as ``solve_diffusion3d`` builds it
for the kernels, its coefficient stated as data in the configuration
(``coefficient``, a form of ``coefficients.py``).

The configuration gives the problem class (``problem.class``, a dotted
name in the port), its padding arguments (``problem.kwargs``) and the
``multigrid`` schedule (the fields of ``MultigridConfig``).  The program
has to hold a compensated residual for the finest operator
(``precision.compensable``): refinement without one corrects toward
another operator's solution, so a program without it is refused before the
hierarchy is built.

The right-hand side is the port's b = f h^2 rule, the same as
``systems/poisson_dirichlet.py``'s (``problems/diffusion3d.py`` takes
``problems/poisson3d.py``'s ``poisson3d_rhs``).
"""

from __future__ import annotations

import importlib

import torch

import coefficients
import harness

rhs = harness.load_module(harness.BENCH / "systems"
                          / "poisson_dirichlet.py").rhs


def build(config: dict, device):
    """(hierarchy, MultigridConfig) of the program, built by its problem
    class from the configuration's coefficient."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import precision
    if not hasattr(precision, "compensable"):
        raise RuntimeError("the program has no compensated residual for a "
                           "variable-coefficient operator "
                           "(precision.compensable)")
    fields = dict(config["multigrid"])
    fields["dtype"] = getattr(torch, fields["dtype"])
    cfg = tmg.MultigridConfig(**fields)
    module, cls = config["problem"]["class"].rsplit(".", 1)
    problem = getattr(importlib.import_module(module), cls)(
        cfg, coefficient=coefficients.callable_of(config["coefficient"]),
        device=device, **config["problem"]["kwargs"])
    hier = problem.hierarchy
    if not precision.compensable(hier.levels[0]):
        raise RuntimeError(f"the program has no compensated residual for "
                           f"{type(hier.levels[0]).__name__}")
    return hier, cfg
