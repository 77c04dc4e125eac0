"""System: the port's 3D Bratu problem -lap(u) - lam e^u = f on
homogeneous Dirichlet faces, built as ``solve_bratu(ndim=3)`` builds it for
the FAS kernels, with the configuration's ``lambda``.

The configuration gives the problem class (``problem.class``, a dotted
name in the port), its padding arguments (``problem.kwargs``) and the
``multigrid`` schedule (the fields of ``MultigridConfig``).

The right-hand side is the port's b = f h^2 rule, the same as
``systems/poisson_dirichlet.py``'s (``problems/bratu.py`` takes
``problems/poisson3d.py``'s ``poisson3d_rhs``).
"""

from __future__ import annotations

import importlib

import torch

import harness

rhs = harness.load_module(harness.BENCH / "systems"
                          / "poisson_dirichlet.py").rhs


def build(config: dict, device):
    """(hierarchy, MultigridConfig) of the program, built by its problem
    class with the configuration's ``lambda``."""
    import tpu_multigrid_torch as tmg
    fields = dict(config["multigrid"])
    fields["dtype"] = getattr(torch, fields["dtype"])
    cfg = tmg.MultigridConfig(**fields)
    module, cls = config["problem"]["class"].rsplit(".", 1)
    problem = getattr(importlib.import_module(module), cls)(
        cfg, lam=config["lambda"], device=device,
        **config["problem"]["kwargs"])
    return problem.hierarchy, cfg
