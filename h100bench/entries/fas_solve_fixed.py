"""Entry: ``tpu_multigrid_torch.cycles.fas.fas_solve_fixed``, the
traffic's ``cycles`` FAS V-cycles from zero, each with its nonlinear
residual norm.  Returns u.

The cell's per-layer metrics read the FAS driver's spans and its count of
blocking reads (``tracing.sync``), so a program whose FAS driver counts
none is refused at its first request."""

from tpu_multigrid_torch import tracing
from tpu_multigrid_torch.cycles import fas


def solve(hier, cfg, b, traffic):
    syncs = tracing.syncs
    res = fas.fas_solve_fixed(hier, cfg, b, traffic["cycles"])
    if tracing.syncs == syncs:
        raise RuntimeError("the program's FAS driver counts no blocking "
                           "reads (tracing.sync): it records no spans")
    return {"u": (res.u,), "iterations": res.iterations,
            "cycles": traffic["cycles"], "converged": res.converged}
