"""iters_per_solve: the mean refinement iterations of the window's solves,
as each solve's result reports them (drivers layer: the refinement loop)."""


def read(run):
    if not run.solves:
        return None
    return sum(s["iterations"] for s in run.solves) / len(run.solves)
