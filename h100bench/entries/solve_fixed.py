"""Entry: ``tpu_multigrid_torch.cycles.solve_fixed``, the traffic's
``cycles`` V-cycles from zero, each with its residual norm.  Returns u."""

from tpu_multigrid_torch import cycles


def solve(hier, cfg, b, traffic):
    res = cycles.solve_fixed(hier, cfg, b, traffic["cycles"])
    return {"u": (res.u,), "iterations": res.iterations,
            "cycles": traffic["cycles"], "converged": res.converged}
