"""The share of its roofline that a fused level-visit kernel reaches over a
traced window, for the ``*_roofline`` readers.

Numerator: the least time the card could take for the level visits the
kernel made (``roofline.k1_work`` / ``k2_work`` at each visited pair, by
``roofline.bound``).  Denominator: the kernel's device time in the trace.

A V-cycle visits each fused level pair once, and the fused pairs are the
finest ones, so the pairs visited are the finest ``launches / cycles`` of
the configuration's levels (``cycles`` as each solve reports them).  Where
that is no whole number, or the schedule is not of the Jacobi family, there
is nothing to read.
"""

from __future__ import annotations

from typing import Optional

import roofline


def share(run, ndim: int, kind: str, kernels, counters) -> Optional[float]:
    """% of the roofline of K1 (``kind="k1"``) or K2 (``"k2"``, with its
    resnorm form) over the traced window."""
    t = run.trace
    mg, levels = run.config["multigrid"], run.config["levels"]
    if (t is None or run.config["ndim"] != ndim
            or mg["smoother"] not in ("jacobi", "chebyshev")):
        return None
    counts = [t.launches.get(c, 0) for c in counters]
    cycles = sum(s["cycles"] for s in run.solves)
    device_s = t.seconds_of(kernels)
    if (cycles <= 0 or sum(counts) <= 0 or sum(counts) % cycles
            or sum(counts) // cycles >= len(levels) or device_s <= 0):
        return None
    visited = [(levels[i], levels[i + 1])
               for i in range(sum(counts) // cycles)]
    if kind == "k1":
        need = sum(roofline.bound(*roofline.k1_work(f, c, mg["nu1"]))[0]
                   for f, c in visited) * cycles
    else:
        need = sum(roofline.bound(*roofline.k2_work(f, c, mg["nu2"]))[0]
                   for f, c in visited) * cycles
        # The resnorm visits are the finest pair's, with the norm added.
        resnorm = counts[1] if len(counts) > 1 else 0
        f, c = visited[0]
        need += resnorm * (
            roofline.bound(*roofline.k2_work(f, c, mg["nu2"], True))[0]
            - roofline.bound(*roofline.k2_work(f, c, mg["nu2"]))[0])
    return 100.0 * need / device_s
