"""Entry: ``tpu_multigrid_torch.precision.solve_refined_ds``, double-single
iterative refinement with one V-cycle as the inner solve, until the
traffic's ``tol`` (relative to ||b||) or a stall, from zero.  Returns the
pair (u_hi, u_lo)."""

from tpu_multigrid_torch import precision


def solve(hier, cfg, b, traffic):
    u_hi, u_lo, hist, iters, ok = precision.solve_refined_ds(
        hier, cfg, b, tol=traffic["tol"], max_iters=traffic["max_iters"])
    return {"u": (u_hi, u_lo), "iterations": iters, "cycles": iters,
            "converged": ok, "computed": float(hist[iters] / hist[0])}
