"""Entry: ``solve_poisson(use_fmg=True, refined=True)``'s route: one
``tpu_multigrid_torch.cycles.fmg`` pass (the right-hand side restricted
down, ``nu0`` V-cycles a level), then ``precision.solve_refined_ds`` from
its answer until the traffic's ``tol`` (relative to the residual the FMG
pass leaves) or a stall.  Returns the pair (u_hi, u_lo).

Both calls run under one ``tracing.solve()`` root, the program's own way
of making two drivers one request (the refinement driver then opens no
root of its own), so that the request's spans, its ``fmg`` span among
them, and its syncs are one request's.

The window sends every request to one hierarchy.  The first request on a
hierarchy runs one FMG pass more, in set-up, watching the span sites it
opens (``tracing.span``): whatever the program prepares for a pass it runs
again is then prepared before the window, and a program whose pass opens
no ``fmg`` span (which the cell's ``fmg_ms`` reads) is refused.  It
watches the sites rather than recording under a profiler, whose first
session in a process takes seconds on the card."""

import weakref

from tpu_multigrid_torch import cycles, precision, tracing

_seen = weakref.WeakSet()


def _opens_fmg_span(hier, cfg, b) -> bool:
    names, span = [], tracing.span

    def watched(name, *args, **kw):
        names.append(name)
        return span(name, *args, **kw)
    tracing.span = watched
    try:
        cycles.fmg(hier, cfg, b)
    finally:
        tracing.span = span
    return "fmg" in names


def solve(hier, cfg, b, traffic):
    if hier not in _seen:
        if not _opens_fmg_span(hier, cfg, b):
            raise RuntimeError("the program's FMG pass opens no fmg span")
        _seen.add(hier)
    with tracing.solve() as root:
        u0 = cycles.fmg(hier, cfg, b)
        u_hi, u_lo, hist, iters, ok = precision.solve_refined_ds(
            hier, cfg, b, tol=traffic["tol"],
            max_iters=traffic["max_iters"], u0=u0)
        root.set(iterations=iters)
    return {"u": (u_hi, u_lo), "iterations": iters, "cycles": iters,
            "converged": ok, "computed": float(hist[iters] / hist[0])}
